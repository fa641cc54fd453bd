"""The models (the classifiers of ``cnn``; the LM stack of ``transformer``
over ``layers`` and ``recurrent``), and ``params_from_numpy``, which
carries a JAX init across into the port's tree of tensors.

The JAX package's parameters are nested dicts (and, for the LM's
``blocks_unrolled``, lists) of arrays; the port keeps the same tree. A bf16
leaf of ``jax.device_get`` arrives with the ``ml_dtypes`` ``bfloat16``
dtype, which ``torch.from_numpy`` refuses, so it goes through float32, which
holds every bf16 value exactly.
"""
from __future__ import annotations

from typing import Any, Optional

import numpy as np
import torch

from repro_torch.models import cnn, layers, recurrent, transformer
from repro_torch.models.cnn import (
    MLP,
    CifarCNN,
    MnistCNN,
    accuracy,
    cifar_cnn_apply,
    classification_loss,
    count_params,
    init_cifar_cnn,
    init_mnist_cnn,
    make_cnn_loss_fn,
    mlp_bundle,
    mnist_cnn_apply,
)

Tree = Any


def _leaf_from_numpy(arr, device) -> torch.Tensor:
    arr = np.asarray(arr)
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.astype(np.float32)).to(device=device, dtype=torch.bfloat16)
    return torch.from_numpy(np.array(arr)).to(device)


def params_from_numpy(np_params: Tree, device=None, *, like: Optional[Tree] = None, path: str = "",
                      mesh=None, cfg=None) -> Tree:
    """A JAX init (``jax.device_get`` of its parameter tree) as the port's
    tree on ``device``. With ``like`` (a port tree of the same model, such as
    ``transformer.init_params``'s or a module's ``named_parameters()``),
    checks that names, shapes and dtypes match it. With ``mesh`` (a
    ``dist.sharding.RankMesh``) and the model's ``cfg``, this rank's part
    is cut before anything is copied (``dist.sharding.rank_params``): its
    tensor-parallel slices over a "model" axis larger than 1, and each
    MoE's experts where the MoE exchanges over "data"."""
    if mesh is not None:
        from repro_torch.dist.sharding import rank_params

        return params_from_numpy(rank_params(np_params, mesh, cfg), device, path=path,
                                 like=None if like is None else rank_params(like, mesh, cfg))
    if isinstance(np_params, dict):
        if like is not None and set(np_params) != set(like):
            raise ValueError(f"{path or 'tree'}: names {sorted(np_params)} != the port's {sorted(like)}")
        return {k: params_from_numpy(v, device, like=None if like is None else like[k], path=f"{path}/{k}")
                for k, v in np_params.items()}
    if isinstance(np_params, (list, tuple)):
        if like is not None and len(np_params) != len(like):
            raise ValueError(f"{path}: {len(np_params)} entries != the port's {len(like)}")
        return [params_from_numpy(v, device, like=None if like is None else like[i], path=f"{path}/{i}")
                for i, v in enumerate(np_params)]
    out = _leaf_from_numpy(np_params, device)
    if like is not None and tuple(out.shape) != tuple(like.shape):
        raise ValueError(f"{path}: shape {tuple(out.shape)} != the port's {tuple(like.shape)}")
    if like is not None and out.dtype != like.dtype:
        raise ValueError(f"{path}: dtype {out.dtype} != the port's {like.dtype}")
    return out


__all__ = [
    "cnn",
    "layers",
    "recurrent",
    "transformer",
    "MLP",
    "CifarCNN",
    "MnistCNN",
    "accuracy",
    "cifar_cnn_apply",
    "classification_loss",
    "count_params",
    "init_cifar_cnn",
    "init_mnist_cnn",
    "make_cnn_loss_fn",
    "mlp_bundle",
    "mnist_cnn_apply",
    "params_from_numpy",
]
