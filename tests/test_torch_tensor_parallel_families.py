"""Tensor parallelism over a "model" axis for the RG-LRU, MLA, MoE and
mLSTM / sLSTM families in the port against the JAX package, on the CPU
(ROADMAP.md Queue 1 item 16b).

The smoke configs of recurrentgemma-9b (RG-LRU and windowed MQA: one KV
head shared by every model rank), xlstm-350m (3 mLSTM + 1 sLSTM),
deepseek-v3-671b (MLA with a shared expert) and arctic-480b (GQA on 2 KV
heads, MoE with a dense residual), each trained on 4 clients over 2 edges,
kappa (2, 2). The port's ranks are processes of one gloo world per size
(``dist.launch.spawn`` running ``tests/torch_mp_ranks.tp_world``): 2 ranks
on a ("data", "model") mesh of (1, 2), 4 ranks on (2, 2) and (1, 4).
JAX's references are its single-device functions on the same numpy inputs
and the JAX init: ``build_train_step`` over one cloud interval, ``prefill``
/ ``decode_step`` (for an MoE whose experts exchange over a "data" axis of
2, each request alone: one token group a rank, as the exchange has it).

- The train cell against one device: every call's loss and grad norm
  ``rtol=1e-5``; the params after the cloud interval, reassembled from the
  ranks' blocks (the strided sLSTM bias among them), ``atol=1e-5``.
- The prefill and decode cells: logits ``rtol=atol=1e-5``, greedy tokens
  fed from JAX's run; the decode states hold the rank's channels or heads.
- Each call's collectives, counted per family.
- The control: two ranks that swap their slices of a split 1-D leaf (the
  RG-LRU's ``lambda``, the mLSTM's ``a_i``) miss the logits.
- ``transformer.init_params(mesh=)`` draws the whole init and keeps the
  rank's part, block by block: equal to the whole init cut.
"""
import dataclasses
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import optim as joptim
from repro.configs import registry as jreg
from repro.core import hierfavg as jh
from repro.dist import sharding as jsh
from repro.models import transformer as jt
from repro_torch.configs.base import ShapeSpec
from repro_torch.dist import launch, sharding
from repro_torch.launch import steps
from repro_torch.models import transformer

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_mp_ranks as ranks  # noqa: E402
from test_torch_tensor_parallel import (  # noqa: E402
    DECODE, LOGITS, MAX_LEN, PROMPT, _check_serve, _check_train, _FakeMesh)

ARCHS = ("recurrentgemma-9b", "xlstm-350m", "deepseek-v3-671b", "arctic-480b")
FED = {"edges_per_pod": 2, "clients_per_edge": 2, "kappa1": 2, "kappa2": 2}
FIELDS = {"fed": FED}
SHAPE, LR = ("train_cut", 8, 4, "train"), 0.05  # 4 clients, b 1
MESHES = ((1, 2), (2, 2), (1, 4))
# the controls' leaves: split 1-D gate parameters (the sLSTM bias's init,
# [0, 1, 0, 0] by gate, is the same in every rank's part)
SWAPS = {"recurrentgemma-9b": ("tail0", "rnn", "lambda"), "xlstm-350m": ("blocks", "b0", "cell", "a_i")}


def _jcfg(arch):
    cfg = jreg.get_smoke(arch)
    return dataclasses.replace(cfg, fed=dataclasses.replace(cfg.fed, **FED))


def _jax_train(arch, seed):
    """JAX's single-device train step over one cloud interval from its init:
    the init, the batches, every call's (loss, grad norm) and the final
    stacked params leaves."""
    cfg = _jcfg(arch)
    topo = jsh.topology_for(cfg, _FakeMesh(data=1))
    hier = cfg.fed.schedule()
    cell = steps.build_train_cell(ranks.tp_config(FIELDS, arch), ShapeSpec(*SHAPE), None, lr=LR, device="cpu")
    shape, accum = tuple(cell.arg_structs[1]["inputs"].shape), cell.meta["grad_accum"]
    params = jt.init_params(jax.random.PRNGKey(seed), cfg)
    rng = np.random.default_rng(seed)
    batches = [{k: rng.integers(0, cfg.vocab_size, size=shape).astype(np.int32) for k in ("inputs", "targets")}
               for _ in range(hier.kappa1 * hier.kappa2)]
    step = jax.jit(jh.build_train_step(jt.make_loss_fn(cfg), joptim.sgd(LR), topo, hier,
                                       jnp.ones((topo.num_clients,), jnp.float32), grad_accum=accum))
    state = jh.init_state(jax.random.PRNGKey(1), params, joptim.sgd(LR), topo, hier)
    metrics = []
    for b in batches:
        state, m = step(state, b)
        metrics.append((float(m["loss"]), float(m["grad_norm"])))
    return {"params": jax.device_get(params), "batches": batches, "metrics": metrics, "accum": accum,
            "final": [np.asarray(x) for x in jax.tree_util.tree_leaves(jax.device_get(state.params))]}


def _jax_serve(arch, params, per_request=False):
    """JAX's prefill and greedy decode steps on two prompts; ``per_request``:
    each prompt alone (its own MoE token group)."""
    cfg = _jcfg(arch)
    prompts = np.random.default_rng(5).integers(0, cfg.vocab_size, size=(2, PROMPT)).astype(np.int32)
    prefill = jax.jit(lambda p, x: jt.prefill(p, cfg, x, MAX_LEN))
    step = jax.jit(lambda p, c, t, pos: jt.decode_step(p, cfg, c, t, pos))
    rows = [slice(0, 1), slice(1, 2)] if per_request else [slice(0, 2)]
    out = {"prompts": prompts, "prefill": [], "decode": [[] for _ in range(DECODE)], "tokens": []}
    for r in rows:
        logits, caches = prefill(params, prompts[r])
        out["prefill"].append(np.asarray(logits))
        toks = []
        for j in range(DECODE):
            tok = np.asarray(jnp.argmax(logits, axis=-1)).astype(np.int32)
            toks.append(tok)
            logits, caches = step(params, caches, tok, np.full((tok.shape[0],), PROMPT + j, np.int32))
            out["decode"][j].append(np.asarray(logits))
        out["tokens"].append(np.stack(toks, axis=1))
    out["prefill"] = np.concatenate(out["prefill"])
    out["decode"] = [np.concatenate(d) for d in out["decode"]]
    out["tokens"] = np.concatenate(out["tokens"])
    return out


def _moe(arch) -> bool:
    return jreg.get_smoke(arch).moe is not None


@pytest.fixture(scope="module")
def refs():
    out = {}
    for i, arch in enumerate(ARCHS):
        train = _jax_train(arch, 10 + i)
        out[arch] = {"train": train, "serve": _jax_serve(arch, train["params"])}
        if _moe(arch):
            out[arch]["serve_ep"] = _jax_serve(arch, train["params"], per_request=True)
    return out


def _serve_ref(refs, arch, mesh):
    return refs[arch]["serve_ep" if _moe(arch) and mesh[0] == 2 else "serve"]


def _jobs(refs, meshes, controls=False):
    jobs = []
    for arch in ARCHS:
        t = refs[arch]["train"]
        for mesh in meshes:
            s = _serve_ref(refs, arch, mesh)
            jobs.append({"kind": "train", "arch": arch, "mesh": mesh, "cfg": FIELDS, "shape": SHAPE,
                         "params": t["params"], "batches": t["batches"], "lr": LR})
            jobs.append({"kind": "serve", "arch": arch, "mesh": mesh, "cfg": FIELDS, "params": t["params"],
                         "prompts": s["prompts"], "tokens": s["tokens"], "max_len": MAX_LEN})
            if controls and arch in SWAPS:
                jobs.append(dict(jobs[-1], swap=SWAPS[arch]))
    return jobs


def _index(jobs):
    """(kind, arch, mesh, swapped) -> the job's place in the world's list."""
    return {(j["kind"], j["arch"], j["mesh"], "swap" in j): i for i, j in enumerate(jobs)}


@pytest.fixture(scope="module")
def two_ranks(refs):
    """One 2-rank world at (1, 2): every family trained and served, and the
    swapped-slice controls."""
    jobs = _jobs(refs, [(1, 2)], controls=True)
    return _index(jobs), launch.spawn(ranks.tp_world, 2, "gloo", (jobs,))


@pytest.fixture(scope="module")
def four_ranks(refs):
    """One 4-rank world: every family at (2, 2) and (1, 4)."""
    jobs = _jobs(refs, [(2, 2), (1, 4)])
    return _index(jobs), launch.spawn(ranks.tp_world, 4, "gloo", (jobs,))


def _world(mesh, two_ranks, four_ranks):
    index, world = two_ranks if mesh == (1, 2) else four_ranks
    return index, world


def _results(mesh, kind, arch, two_ranks, four_ranks, swapped=False):
    index, world = _world(mesh, two_ranks, four_ranks)
    i = index[(kind, arch, mesh, swapped)]
    return [w[i] for w in world]


def _layers(arch):
    cfg = jreg.get_smoke(arch)
    kinds = [cfg.block_pattern[i % cfg.pattern_period] for i in range(cfg.num_layers - cfg.tail_layers)]
    return kinds + list(cfg.block_pattern[:cfg.tail_layers])


def _serve_sums(arch) -> int:
    """A forward's sums over the model ranks: one per row-parallel output
    (``wo``, ``w_out``, ``w_down``, ``w2``) and one per MoE combine."""
    cfg = jreg.get_smoke(arch)
    n = 0
    for kind in _layers(arch):
        n += 1  # the mixer's output
        if cfg.moe is not None and kind in ("attn", "local_attn"):
            n += 1 + (cfg.moe.num_shared_experts > 0) + cfg.moe.dense_residual
        elif cfg.d_ff > 0 and kind not in ("mlstm", "slstm"):
            n += 1
    return n


def _backward_sums(arch, model: int) -> int:
    """A backward's sums: one per ``model_copy`` (MLA: the query latent,
    ``c_kv`` and ``k_rope``; the mLSTM: ``u`` and its input; the MoE: its
    input and its gates) and two per shared KV head's projections."""
    cfg = jreg.get_smoke(arch)
    n = 0
    for kind in _layers(arch):
        if kind in ("attn", "local_attn"):
            n += 3 if cfg.mla is not None else 1 + (2 if cfg.num_kv_heads < model else 0)
        else:
            n += {"rglru": 1, "mlstm": 2, "slstm": 1}[kind]
        if cfg.moe is not None and kind in ("attn", "local_attn"):
            n += 2 + (cfg.moe.num_shared_experts > 0) + cfg.moe.dense_residual
        elif cfg.d_ff > 0 and kind not in ("mlstm", "slstm"):
            n += 1
    return n


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: "x".join(map(str, m)))
@pytest.mark.parametrize("arch", ARCHS)
def test_the_train_cell_tracks_jax(arch, mesh, refs, two_ranks, four_ranks):
    results = _results(mesh, "train", arch, two_ranks, four_ranks)
    ref = refs[arch]["train"]
    _check_train(results, ref, mesh)
    want = _serve_sums(arch) + _backward_sums(arch, mesh[1]) + 2  # and the loss's sum and its input's copy
    for r in results:
        assert r["meta"]["model"] == mesh[1] and r["meta"]["sharded"] == (mesh[0] > 1)
        for c in r["counts"]:
            assert c["tp_all_reduce"] == want, (c, want)
            assert c["tp_all_reduce_max"] == 1 and c["tp_all_gather"] == 1 and c["tp_grad_norm"] == 1, c
            assert c["all_to_all"] == 0, c
        assert [c["all_reduce"] for c in r["counts"]] == ([0, 0, 0, 1] if mesh[0] > 1 else [0] * 4)


def _check_states(arch, shapes, model):
    """The decode caches a rank holds: the RG-LRU's dr / M channels, the
    xLSTM states' H / M heads, MLA's latent whole, a GQA cache's KV heads."""
    cfg = jreg.get_smoke(arch)
    for path, shape in shapes.items():
        leaf = path.split("/")[-1]
        if leaf in ("h", "conv") and arch == "recurrentgemma-9b":
            assert shape[-1] == cfg.d_rnn_resolved // model, (path, shape)
        elif arch == "xlstm-350m":  # stacked (1, B, H, ...)
            assert shape[2] == cfg.num_heads // model, (path, shape)
        elif leaf == "c_kv":
            assert shape[-1] == cfg.mla.kv_lora_rank, (path, shape)
        elif leaf in ("k", "v"):
            assert shape[-2] == max(1, cfg.num_kv_heads // model), (path, shape)


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: "x".join(map(str, m)))
@pytest.mark.parametrize("arch", ARCHS)
def test_the_serving_cells_track_jax(arch, mesh, refs, two_ranks, four_ranks):
    results = _results(mesh, "serve", arch, two_ranks, four_ranks)
    _check_serve(results, _serve_ref(refs, arch, mesh), mesh)
    moe_calls = len(_layers(arch)) if _moe(arch) and mesh[0] == 2 else 0  # each exchanges over "data"
    for r in results:
        for c in (r["prefill_counts"], r["decode_counts"]):  # the prefill, and the last decode step
            assert c["tp_all_reduce"] == _serve_sums(arch) and c["tp_all_gather"] == 2, c
            assert c["tp_all_reduce_max"] == 0 and c["all_to_all"] == 2 * moe_calls, c
        _check_states(arch, r["cache_shapes"], mesh[1])


@pytest.mark.parametrize("arch", sorted(SWAPS))
def test_swapping_two_ranks_slices_of_a_split_1d_leaf_fails(arch, refs, two_ranks):
    """Two model ranks that trade their halves of the RG-LRU's ``lambda`` (a
    tail layer's) or the mLSTM's ``a_i`` miss JAX's logits; unswapped, the
    same world matches them."""
    want = refs[arch]["serve"]
    got = _results((1, 2), "serve", arch, two_ranks, None, swapped=True)[0]
    np.testing.assert_allclose(_results((1, 2), "serve", arch, two_ranks, None)[0]["prefill"], want["prefill"],
                               **LOGITS)
    with pytest.raises(AssertionError):
        np.testing.assert_allclose(got["prefill"], want["prefill"], **LOGITS)


class _Rank(_FakeMesh):
    def __init__(self, r, **shape):
        super().__init__(**shape)
        self.r = r

    def axis_index(self, name):
        return self.r if name == "model" else 0


@pytest.mark.parametrize("arch", ARCHS)
def test_a_rank_init_is_the_whole_init_cut(arch):
    """``init_params(mesh=)`` keeps the rank's part of each block as it is
    drawn: equal, leaf for leaf, to the whole init cut by ``rank_params``."""
    cfg = ranks.tp_config({}, arch)
    whole = transformer.init_params(torch.Generator().manual_seed(3), cfg)
    for r in range(2):
        mesh = _Rank(r, data=1, model=2)
        got = transformer.init_params(torch.Generator().manual_seed(3), cfg, mesh=mesh)
        want = sharding.rank_params(whole, mesh, cfg)
        from repro_torch.tree import leaves

        pairs = list(zip(leaves(got), leaves(want)))
        assert len(pairs) == len(list(leaves(whole)))
        for a, b in pairs:
            assert a.shape == b.shape and torch.equal(a, b)
        assert sum(a.numel() for a, _ in pairs) < sum(x.numel() for x in leaves(whole))


@pytest.mark.parametrize("arch,fields,model,match", [
    ("recurrentgemma-9b", {"d_rnn": 66}, 4, "RG-LRU width d_rnn 66 do not split"),
    ("xlstm-350m", {}, 8, "xLSTM heads 4 do not split"),
    ("deepseek-v3-671b", {"d_ff_expert": 66}, 4, "expert width d_ff_expert 66 do not split"),
])
def test_family_counts_that_do_not_split_are_refused_by_name(arch, fields, model, match):
    cfg = ranks.tp_config({}, arch)
    if "d_ff_expert" in fields:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, **fields))
    else:
        cfg = dataclasses.replace(cfg, **fields)
    with pytest.raises(ValueError, match=match):
        sharding.refuse_model_axis(_FakeMesh(data=1, model=model), cfg)
