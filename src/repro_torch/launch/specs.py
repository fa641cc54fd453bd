"""Stand-ins for every model input, with their specs: the port of
``repro.launch.specs`` (``:22-111``).

A stand-in is a ``torch.empty(..., device="meta")`` tensor: the shape and
dtype of the global array, with no storage. Each comes with its
``dist.sharding.PartitionSpec``, whose ``shard(x, mesh)`` is a rank's part
of the concrete array. Stub frontends (``embed_inputs`` off) take float
embeddings in place of tokens.
"""
from __future__ import annotations

from typing import Any, Tuple

import torch

from repro_torch.configs.base import ArchConfig, ShapeSpec
from repro_torch.dist.sharding import fed_rules, serve_rules, topology_for

PyTree = Any


def meta(shape, dtype: torch.dtype) -> torch.Tensor:
    """A stand-in: shape and dtype, no storage."""
    return torch.empty(tuple(shape), dtype=dtype, device="meta")


def _embed_dtype(cfg: ArchConfig) -> torch.dtype:
    return torch.bfloat16 if cfg.param_dtype == "bfloat16" else torch.float32


def train_batch_specs(cfg: ArchConfig, shape: ShapeSpec, mesh) -> Tuple[PyTree, PyTree, int]:
    """(batch stand-ins, batch specs, grad_accum).

    Batch leaves: (accum, N, micro, S[, d]) when accum > 1, else (N, b,
    S[, d]); micro = min(cfg.microbatch, b), accum = b // micro."""
    rules = fed_rules(cfg, mesh)
    topo = topology_for(cfg, mesh)
    n = topo.num_clients
    if shape.global_batch % n:
        raise ValueError(f"global_batch {shape.global_batch} % N={n} != 0")
    b = shape.global_batch // n
    micro = min(cfg.microbatch, b)
    accum = b // micro
    has_accum = accum > 1
    lead = (accum, n, micro) if has_accum else (n, b)
    if cfg.embed_inputs:
        in_shape, in_dtype = lead + (shape.seq_len,), torch.int32
    else:
        in_shape, in_dtype = lead + (shape.seq_len, cfg.d_model), _embed_dtype(cfg)
    tgt_shape = lead + (shape.seq_len,)
    batch = {"inputs": meta(in_shape, in_dtype), "targets": meta(tgt_shape, torch.int32)}
    specs = {"inputs": rules.batch_spec(in_shape, has_accum=has_accum),
             "targets": rules.batch_spec(tgt_shape, has_accum=has_accum)}
    return batch, specs, accum


def prefill_request_specs(cfg: ArchConfig, shape: ShapeSpec, mesh) -> Tuple[torch.Tensor, Any]:
    """(prompt stand-in, its spec): (B, S) tokens or (B, S, d) embeddings."""
    rules = serve_rules(cfg, mesh)
    if cfg.embed_inputs:
        s, dt = (shape.global_batch, shape.seq_len), torch.int32
    else:
        s, dt = (shape.global_batch, shape.seq_len, cfg.d_model), _embed_dtype(cfg)
    return meta(s, dt), rules.request_spec(s)


def decode_request_specs(cfg: ArchConfig, shape: ShapeSpec, mesh) -> Tuple[PyTree, PyTree]:
    """({"tokens", "position"} stand-ins, their specs) for one decode step."""
    rules = serve_rules(cfg, mesh)
    B = shape.global_batch
    if cfg.embed_inputs:
        tok_shape: Tuple[int, ...] = (B,)
        dt = torch.int32
    else:
        tok_shape, dt = (B, cfg.d_model), _embed_dtype(cfg)
    structs = {"tokens": meta(tok_shape, dt), "position": meta((B,), torch.int32)}
    specs = {"tokens": rules.request_spec(tok_shape), "position": rules.request_spec((B,))}
    return structs, specs


def input_specs(cfg: ArchConfig, shape: ShapeSpec, mesh) -> PyTree:
    """The stand-ins for every model input of this cell (training batch or
    serving request)."""
    if shape.kind == "train":
        return train_batch_specs(cfg, shape, mesh)[0]
    if shape.kind == "prefill":
        return {"inputs": prefill_request_specs(cfg, shape, mesh)[0]}
    if shape.kind == "decode":
        return decode_request_specs(cfg, shape, mesh)[0]
    raise ValueError(shape.kind)
