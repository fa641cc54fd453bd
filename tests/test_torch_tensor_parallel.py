"""Tensor parallelism over a "model" axis in the port against the JAX
package, on the CPU (ROADMAP.md Queue 1 item 16, the dense families, and
the layout of item 16b's).

The port's ranks are processes of one gloo world per size
(``dist.launch.spawn`` running ``tests/torch_mp_ranks.tp_world``): 2 ranks
on a ("data", "model") mesh of (1, 2), 4 ranks on (2, 2) and (1, 4). JAX's
references are its single-device functions on the same numpy inputs and
the JAX init: ``build_train_step`` over one cloud interval, ``prefill`` /
``decode_step``, ``cross_entropy``.

- The train cell at (1, 2) and (2, 2) against one device: every call's
  loss and grad norm ``rtol=1e-5``; the params after the cloud interval,
  reassembled from the ranks' blocks, ``atol=1e-5``. At (1, 4) on 2 KV
  heads each pair of ranks shares one (their gradients summed).
- The prefill and decode cells: logits ``rtol=atol=1e-5`` at each mesh,
  greedy tokens fed from JAX's run; a rank holds 1 / M of every split leaf
  and its KV heads' cache.
- ``cross_entropy`` vocab-parallel against JAX's, with its gradient.
- The collectives of each call: 4L + 2 sums per loss and gradient (2L
  forward after ``wo`` / ``w2`` and the loss's sums, 2L backward before
  ``wq..wv`` / ``w1, w3`` and the LM head's input), one max and one
  gather; prefill and decode 2L sums and two gathers.
- The spec table against JAX's ``ShardingRules``, the dense families and
  (item 16b) recurrentgemma-9b, xlstm-350m, deepseek-v3-671b and
  arctic-480b at their published widths: the only differences are the
  leaves ``DIFFERENCES`` names, each with the bytes a rank holds; every
  family builds its cells on a model axis, and counts that do not split
  are refused by name (the families' numbers against JAX:
  ``tests/test_torch_tensor_parallel_families.py``).
- The control: two ranks that swap their ``wo`` slices miss the logits.
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
from repro_torch.configs import registry as treg
from repro_torch.configs.base import ShapeSpec
from repro_torch.dist import launch, sharding
from repro_torch.launch import steps
from repro_torch.tree import leaves

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_mp_ranks as ranks  # noqa: E402

# 8 query heads over 4 KV heads split 2 and 4 ways; 2 KV heads over 4
# model ranks share one head a pair of ranks
DENSE = dict(num_heads=8, num_kv_heads=4, head_dim=8, d_ff=128, vocab_size=96)
SHARED_KV = dict(DENSE, num_kv_heads=2)
WHOLE_VOCAB = dict(DENSE, vocab_size=99)  # does not split: the LM head stays whole, as JAX's rule keeps it
SHAPE, LR = ("train_cut", 8, 16, "train"), 0.05  # 4 clients, b 4, microbatch 1: 4 accumulated a step
PROMPT, MAX_LEN, DECODE = 8, 12, 3
TOL = dict(rtol=1e-5, atol=1e-7)
PARAMS_ATOL = 1e-5
LOGITS = dict(rtol=1e-5, atol=1e-5)


def rank_mesh_stand_in(shape):
    """Rank 0's ``RankMesh`` of a ("data", "model") mesh of ``shape`` on the
    CPU, without process groups: enough to build a cell, not to run one."""
    return sharding.RankMesh(("data", "model"), tuple(shape), 0, None, torch.device("cpu"), "gloo",
                             {"data": None, "model": None})


class _FakeMesh:
    def __init__(self, **shape):
        self.axis_names = tuple(shape)
        self.shape = dict(shape)


def _jcfg(fields):
    import dataclasses

    return dataclasses.replace(jreg.get_smoke("granite-3-2b"), **fields)


def _jax_train(fields, seed):
    """JAX's single-device train step over one cloud interval from its init:
    the init, the batches, every call's (loss, grad norm) and the final
    stacked params leaves."""
    cfg = _jcfg(fields)
    tcfg = ranks.tp_config(fields)
    topo = jsh.topology_for(cfg, _FakeMesh(data=1))
    hier = cfg.fed.schedule()
    cell = steps.build_train_cell(tcfg, ShapeSpec(*SHAPE), None, lr=LR, device="cpu")
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


def _jax_serve(fields, params):
    """JAX's prefill and greedy decode steps on two prompts."""
    cfg = _jcfg(fields)
    prompts = np.random.default_rng(5).integers(0, cfg.vocab_size, size=(2, PROMPT)).astype(np.int32)
    logits, caches = jax.jit(lambda p, x: jt.prefill(p, cfg, x, MAX_LEN))(params, prompts)
    out = {"prompts": prompts, "prefill": np.asarray(logits), "decode": [], "tokens": []}
    step = jax.jit(lambda p, c, t, pos: jt.decode_step(p, cfg, c, t, pos))
    for j in range(DECODE):
        tok = np.asarray(jnp.argmax(logits, axis=-1)).astype(np.int32)
        out["tokens"].append(tok)
        logits, caches = step(params, caches, tok, np.full((2,), PROMPT + j, np.int32))
        out["decode"].append(np.asarray(logits))
    out["tokens"] = np.stack(out["tokens"], axis=1)
    return out


def _jax_cross_entropy():
    rng = np.random.default_rng(9)
    logits = (3.0 * rng.normal(size=(3, 5, 96))).astype(np.float32)
    targets = rng.integers(0, 96, size=(3, 5)).astype(np.int32)
    mask = (rng.random((3, 5)) > 0.3).astype(np.float32)
    loss, grad = jax.value_and_grad(lambda x: jt.cross_entropy(x, targets, mask))(logits)
    return {"logits": logits, "targets": targets, "mask": mask, "loss": float(loss), "grad": np.asarray(grad)}


@pytest.fixture(scope="module")
def refs():
    dense, shared, whole = _jax_train(DENSE, 0), _jax_train(SHARED_KV, 1), _jax_train(WHOLE_VOCAB, 2)
    return {"dense": dense, "shared": shared, "whole": whole, "serve_dense": _jax_serve(DENSE, dense["params"]),
            "serve_shared": _jax_serve(SHARED_KV, shared["params"]),
            "serve_whole": _jax_serve(WHOLE_VOCAB, whole["params"]), "ce": _jax_cross_entropy()}


def _train_job(ref, fields, mesh):
    return {"kind": "train", "mesh": mesh, "cfg": fields, "shape": SHAPE, "params": ref["params"],
            "batches": ref["batches"], "lr": LR}


def _serve_job(ref, fields, mesh, params, swap=None):
    return {"kind": "serve", "mesh": mesh, "cfg": fields, "params": params, "prompts": ref["prompts"],
            "tokens": ref["tokens"], "max_len": MAX_LEN, "swap": swap}


@pytest.fixture(scope="module")
def two_ranks(refs):
    """One 2-rank world at (1, 2): the train cell, the serving cells, the
    swapped-``wo`` control, the vocab-parallel loss, and the whole-vocabulary
    config trained and served."""
    d, s, ce, w = refs["dense"], refs["serve_dense"], refs["ce"], refs["whole"]
    jobs = [_train_job(d, DENSE, (1, 2)), _serve_job(s, DENSE, (1, 2), d["params"]),
            _serve_job(s, DENSE, (1, 2), d["params"], swap=("blocks", "b0", "attn", "wo")),
            {"kind": "cross_entropy", "mesh": (1, 2), "logits": ce["logits"], "targets": ce["targets"],
             "mask": ce["mask"]},
            _train_job(w, WHOLE_VOCAB, (1, 2)), _serve_job(refs["serve_whole"], WHOLE_VOCAB, (1, 2), w["params"])]
    return launch.spawn(ranks.tp_world, 2, "gloo", (jobs,))


@pytest.fixture(scope="module")
def four_ranks(refs):
    """One 4-rank world: the dense config at (2, 2), the shared-KV one at
    (1, 4), each trained and served."""
    d, sh = refs["dense"], refs["shared"]
    jobs = [_train_job(d, DENSE, (2, 2)), _serve_job(refs["serve_dense"], DENSE, (2, 2), d["params"]),
            _train_job(sh, SHARED_KV, (1, 4)), _serve_job(refs["serve_shared"], SHARED_KV, (1, 4), sh["params"])]
    return launch.spawn(ranks.tp_world, 4, "gloo", (jobs,))


def _check_train(results, ref, mesh_shape):
    data, model = mesh_shape
    rows = [results[d * model] for d in range(data)]  # model index 0 of each data line
    for j, (loss, gnorm) in enumerate(ref["metrics"]):
        if data == 1:
            got = (float(rows[0]["metrics"][j]["loss"]), float(rows[0]["metrics"][j]["grad_norm"]))
        else:  # per client on each data rank
            got = (np.concatenate([r["metrics"][j]["loss"] for r in rows]).mean(),
                   np.sqrt(np.concatenate([r["metrics"][j]["gsq"] for r in rows]).sum()))
        np.testing.assert_allclose(got[0], loss, **TOL, err_msg=f"call {j} loss")
        np.testing.assert_allclose(got[1], gnorm, **TOL, err_msg=f"call {j} grad norm")
    for i, want in enumerate(ref["final"]):
        full = np.full(want.size, np.nan)
        for r in results:
            block, index = r["blocks"][i]
            seen = ~np.isnan(full[index.ravel()])
            np.testing.assert_allclose(full[index.ravel()][seen], block.ravel()[seen], rtol=0, atol=PARAMS_ATOL,
                                       err_msg=f"leaf {i}: replicas")
            full[index.ravel()] = block.ravel()
        assert not np.isnan(full).any(), f"leaf {i}: not every value is held by a rank"
        np.testing.assert_allclose(full.reshape(want.shape), want, rtol=0, atol=PARAMS_ATOL, err_msg=f"leaf {i}")


def _sums_per_loss(layers: int, shared_kv: bool, split_vocab: bool) -> int:
    """The sums of one loss and gradient: 2L forward, 2L backward, and with
    a split vocabulary the loss's one and the LM head input's one; a shared
    KV head adds its two projections' gradient sums a layer."""
    return 4 * layers + (2 if split_vocab else 0) + (2 * layers if shared_kv else 0)


def _check_train_counts(results, ref, shared_kv=False, split_vocab=True):
    layers = treg.get_smoke("granite-3-2b").num_layers
    for r in results:
        for j, c in enumerate(r["counts"]):
            assert c["tp_all_reduce"] == ref["accum"] * _sums_per_loss(layers, shared_kv, split_vocab), (j, c)
            assert c["tp_all_reduce_max"] == (ref["accum"] if split_vocab else 0), (j, c)
            assert c["tp_all_gather"] == ref["accum"] and c["tp_grad_norm"] == 1, (j, c)
        assert r["meta"]["model"] > 1


def test_the_train_cell_over_two_model_ranks_tracks_jax(refs, two_ranks):
    _check_train([w[0] for w in two_ranks], refs["dense"], (1, 2))
    _check_train_counts([w[0] for w in two_ranks], refs["dense"])
    for w in two_ranks:  # one model line: no client sharding, no cloud all-reduce
        assert not w[0]["meta"]["sharded"] and all(c["all_reduce"] == 0 for c in w[0]["counts"])


def test_the_train_cell_over_a_two_by_two_mesh_tracks_jax(refs, four_ranks):
    _check_train([w[0] for w in four_ranks], refs["dense"], (2, 2))
    _check_train_counts([w[0] for w in four_ranks], refs["dense"])
    for w in four_ranks:  # the cloud sync's one all-reduce, over the data axis, at the last call
        assert w[0]["meta"]["sharded"] and [c["all_reduce"] for c in w[0]["counts"]] == [0, 0, 0, 1]


def test_ranks_that_share_a_kv_head_sum_its_gradient(refs, four_ranks):
    _check_train([w[2] for w in four_ranks], refs["shared"], (1, 4))
    _check_train_counts([w[2] for w in four_ranks], refs["shared"], shared_kv=True)


def _check_serve(results, ref, mesh_shape):
    data, model = mesh_shape
    for r in results:
        assert r["meta"]["model"] == model
    for line in range(data):  # every model rank of a data line returns the gathered logits
        for m in range(1, model):
            np.testing.assert_array_equal(results[line * model + m]["prefill"], results[line * model]["prefill"])
    rows = [results[d * model] for d in range(data)]
    np.testing.assert_allclose(np.concatenate([r["prefill"] for r in rows]), ref["prefill"], **LOGITS)
    for j in range(DECODE):
        np.testing.assert_allclose(np.concatenate([r["decode"][j] for r in rows]), ref["decode"][j], **LOGITS,
                                   err_msg=f"decode step {j}")


def _cache_heads(result) -> int:
    """The KV heads of the first layers' stacked k cache (n, B, L, Hkv, hd)."""
    return result["cache_shapes"]["blocks/b0/k"][-2]


def _check_serve_counts(results, layers, gathers=2):
    for r in results:
        for c in (r["prefill_counts"], r["decode_counts"]):
            assert c["tp_all_reduce"] == 2 * layers and c["tp_all_gather"] == gathers, c
            assert c["tp_all_reduce_max"] == 0 and c["all_to_all"] == 0, c


def test_the_serving_cells_over_model_ranks_track_jax(refs, two_ranks, four_ranks):
    layers = treg.get_smoke("granite-3-2b").num_layers
    whole = sum(int(np.prod(x.shape)) for x in jax.tree_util.tree_leaves(refs["dense"]["params"]))
    d = treg.get_smoke("granite-3-2b").d_model
    norms = layers * 2 * d + d  # the RMSNorm scales a rank keeps whole
    for world, i, shape in ((two_ranks, 1, (1, 2)), (four_ranks, 1, (2, 2))):
        results = [w[i] for w in world]
        _check_serve(results, refs["serve_dense"], shape)
        _check_serve_counts(results, layers)
        for r in results:
            assert r["held"] == (whole - norms) // shape[1] + norms
            assert _cache_heads(r) == DENSE["num_kv_heads"] // shape[1]
    shared = [w[3] for w in four_ranks]
    _check_serve(shared, refs["serve_shared"], (1, 4))
    _check_serve_counts(shared, layers)
    assert all(_cache_heads(r) == 1 for r in shared)  # the one KV head its query heads read


def test_a_vocabulary_that_does_not_split_stays_whole_and_tracks_jax(refs, two_ranks):
    """Vocabulary 99 over 2 model ranks: the LM head whole on each rank (the
    loss as off the mesh, no gather of the logits), the rest split."""
    _check_train([w[4] for w in two_ranks], refs["whole"], (1, 2))
    _check_train_counts([w[4] for w in two_ranks], refs["whole"], split_vocab=False)
    results = [w[5] for w in two_ranks]
    _check_serve(results, refs["serve_whole"], (1, 2))
    _check_serve_counts(results, treg.get_smoke("granite-3-2b").num_layers, gathers=1)


def test_swapping_two_ranks_wo_slices_fails(refs, two_ranks):
    got = two_ranks[0][2]["prefill"]
    with pytest.raises(AssertionError):
        np.testing.assert_allclose(got, refs["serve_dense"]["prefill"], **LOGITS)


def test_the_vocab_parallel_cross_entropy_tracks_jax(refs, two_ranks):
    ce = refs["ce"]
    grads = []
    for w in two_ranks:
        r = w[3]
        np.testing.assert_allclose(r["loss"], ce["loss"], rtol=1e-6)
        assert r["counts"]["tp_all_reduce_max"] == 1 and r["counts"]["tp_all_reduce"] == 1
        grads.append(r["grad"])
    np.testing.assert_allclose(np.concatenate(grads, axis=-1), ce["grad"], rtol=1e-5, atol=1e-7)


# ---------------------------------------------------------------------------
# The layout and the refusals, in one process
# ---------------------------------------------------------------------------


# the leaves whose tensor-parallel spec may differ from JAX's, by kind:
# row-parallel outputs (dim -2 where JAX splits the last), leaves kept whole
# (JAX splits a stacked or 2-D one's last dim), the 1-D gate parameters the
# port splits by channel (JAX keeps a 1-D leaf whole), the sLSTM's
# recurrent blocks by head (dim -3; JAX splits dh), its bias by the rank's
# part of each gate (JAX splits a stacked one's last dim), and a KV head
# shared by several model ranks
DIFFERENCES = {"row": ("wo", "w2", "w_out", "w_down"),
               "whole": sharding.NORMS + ("q_norm", "kv_norm", "wq_a", "wkv_a", "router", "w_up"),
               "channel": ("a_r", "a_i", "a_f", "lambda"), "heads": sharding.SLSTM_RECURRENT,
               "quarters": ("b",), "kv": ("wk", "wv")}


def layout_difference(name, got, want):
    """The kind of ``DIFFERENCES`` under which the port's spec ``got`` of a
    leaf named ``name`` may differ from JAX's ``want`` as it does, or None."""
    got, want = tuple(got), tuple(want)
    kind = next((k for k, names in DIFFERENCES.items() if name in names), None)
    ok = {"row": lambda: got[-2] == "model" and got[-1] is None and want[-1] == "model",
          "whole": lambda: want[-1] == "model" and all(m is None for m in got[1:]),
          "channel": lambda: got[-1] == "model" and want[-1] is None,
          "heads": lambda: got[-3] == "model" and got[-1] is None and want[-1] == "model",
          "quarters": lambda: isinstance(got[-1], sharding.BlockSplit),
          "kv": lambda: isinstance(got[-1], sharding.HeadShare)}
    return kind if kind is not None and ok[kind]() else None


def _held(shape, spec, mesh) -> int:
    """The elements of a leaf of ``shape`` that a rank holds under ``spec``."""
    n = int(np.prod(shape))
    for dim, member in enumerate(tuple(spec)):
        if isinstance(member, sharding.HeadShare):
            n //= member.heads
        elif isinstance(member, sharding.BlockSplit):
            n //= mesh.shape[member.axis]
        elif member is not None:
            n //= int(np.prod([mesh.shape[a] for a in (member if isinstance(member, tuple) else (member,))]))
    return n


def _paths(tree, prefix=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _paths(tree[k], prefix + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _paths(v, prefix + (str(i),))
    else:
        yield prefix, tree


FAMILIES = ("recurrentgemma-9b", "xlstm-350m", "deepseek-v3-671b", "arctic-480b")
FULL_LAYOUTS = ("lm-100m",) + FAMILIES  # the published widths (the families' smoke heads do not split 16 ways)


@pytest.mark.parametrize("arch", ["lm-100m", "granite-3-2b", "yi-9b", "granite-20b", "deepseek-7b",
                                  "internvl2-2b", *FAMILIES])
@pytest.mark.parametrize("model", [2, 4, 16])
def test_the_layout_differs_from_jax_only_on_the_named_leaves(arch, model, monkeypatch):
    """Every spec equals JAX's but on the leaves ``DIFFERENCES`` names, each
    with the bytes a rank holds: a row-parallel output and an sLSTM
    recurrent block as many as JAX's shard (another dim split), the sLSTM
    bias too where JAX splits it (stacked) and 1 / M of it where JAX keeps
    it whole, a whole leaf M times JAX's shard, a 1-D gate parameter 1 / M
    of JAX's whole leaf, and with fewer KV heads than model ranks ``wk`` /
    ``wv`` one whole head."""
    monkeypatch.setattr(jsh, "NamedSharding", lambda mesh, spec: spec)
    mesh = _FakeMesh(data=2, model=model)
    full = arch in FULL_LAYOUTS
    jcfg = jreg.get_config(arch) if full else jreg.get_smoke(arch)
    tcfg = treg.get_config(arch) if full else treg.get_smoke(arch)
    if arch in FAMILIES:  # a count that does not split is refused by name: its layout never runs
        try:
            sharding.refuse_model_axis(mesh, tcfg)
        except ValueError as e:
            assert (arch, model) in ((("xlstm-350m", 16), ("arctic-480b", 16))), e
            return
    shapes = steps.structs(lambda: steps._init_params(tcfg))
    jshapes = jax.tree_util.tree_map(lambda x: jax.ShapeDtypeStruct(tuple(x.shape), np.float32), shapes)
    want = jax.tree_util.tree_leaves(jsh.serve_rules(jcfg, mesh).params_shardings(jshapes),
                                     is_leaf=lambda x: isinstance(x, jsh.P))
    got = list(leaves(sharding.serve_rules(tcfg, mesh).params_shardings(shapes)))
    named = {}
    for (path, x), g, w in zip(_paths(shapes), got, want):
        if tuple(g) == tuple(w):
            continue
        kind = layout_difference(path[-1], g, w)
        assert kind is not None, (path, g, w)
        mine, jax_part, whole = _held(x.shape, g, mesh), _held(x.shape, w, mesh), int(np.prod(x.shape))
        named["/".join(path)] = (kind, mine * x.element_size())
        if kind in ("row", "heads") or (kind == "quarters" and w[-1] == "model"):
            assert mine == jax_part, (path, mine, jax_part)
        elif kind in ("channel", "quarters"):
            assert jax_part == whole and mine * model == whole, (path, mine, whole)
        elif kind == "whole":
            assert mine == whole and jax_part * model == whole, (path, mine, jax_part)
        else:
            assert tcfg.num_kv_heads < model and mine * tcfg.num_kv_heads == whole, (path, mine)
    kinds = {k for k, _ in named.values()}
    assert "row" in kinds and "whole" in kinds
    if arch == "recurrentgemma-9b":  # the unstacked tail's 1-D gate parameters (stacked ones split as JAX's)
        assert "channel" in kinds
    if arch == "xlstm-350m":
        assert {"heads", "quarters"} <= kinds
    replicas = sharding.serve_rules(tcfg, mesh).model_replicas(shapes)
    for (path, _), n, g in zip(_paths(shapes), replicas, got):
        if isinstance(g[-1], sharding.HeadShare):
            assert n == model // tcfg.num_kv_heads
        elif isinstance(g[-1], sharding.BlockSplit):
            assert n == 1
        else:  # a split leaf, or a whole one (the norms, latents, router, w_up; dims that do not split)
            assert n == (1 if "model" in tuple(g) else model), path


def test_a_shared_kv_head_is_the_one_its_query_heads_read():
    """16 query heads on 2 KV heads over 8 model ranks: a rank's 2 query
    heads read one KV head, and ``HeadShare`` cuts that head's columns."""
    class _Rank(_FakeMesh):
        def __init__(self, r, **shape):
            super().__init__(**shape)
            self.r = r

        def axis_index(self, name):
            return self.r if name == "model" else 0

    hd, hq, hkv, m = 4, 16, 2, 8
    w = np.arange(3 * hkv * hd).reshape(3, hkv * hd)
    spec = sharding.P(None, sharding.HeadShare("model", hkv))
    for r in range(m):
        read = {h // (hq // hkv) for h in range(r * hq // m, (r + 1) * hq // m)}
        assert len(read) == 1
        kv = read.pop()
        np.testing.assert_array_equal(spec.shard(w, _Rank(r, data=1, model=m)), w[:, kv * hd:(kv + 1) * hd])


@pytest.mark.parametrize("arch,what", [("recurrentgemma-9b", "RG-LRU blocks"), ("xlstm-350m", "mLSTM / sLSTM"),
                                       ("arctic-480b", "MoE blocks"), ("deepseek-v3-671b", "MoE blocks"),
                                       ("mla", "MLA attention")])
def test_families_without_tensor_parallelism_are_refused_by_name(arch, what):
    """Once refused by name on a "model" axis (ROADMAP.md item 16b), each of
    these families now builds there: the rules pass it, and its train,
    prefill and decode cells build on a ("data", "model") mesh of (1, 2),
    each rank's params a slice of every split leaf
    (``tests/test_torch_tensor_parallel_families.py`` holds their numbers
    to JAX's)."""
    del what
    cfg = (dataclasses.replace(treg.get_smoke("deepseek-v3-671b"), moe=None) if arch == "mla"
           else treg.get_smoke(arch))
    mesh = rank_mesh_stand_in((1, 2))
    sharding.refuse_model_axis(mesh, cfg)
    cells = [steps.build_train_cell(cfg, ShapeSpec("t", 8, cfg.fed.edges_per_pod * cfg.fed.clients_per_edge,
                                                   "train"), mesh),
             steps.build_prefill_cell(cfg, ShapeSpec("p", 8, 2, "prefill"), mesh),
             steps.build_decode_cell(cfg, ShapeSpec("d", 8, 2, "decode"), mesh)]
    for cell in cells:
        assert cell.meta["model"] == 2
        specs = [tuple(x) for x in leaves(cell.arg_specs[0] if cell.meta["kind"] != "train"
                                          else cell.arg_specs[0].params)]
        assert any("model" in x for x in specs)
    sharding.refuse_model_axis(_FakeMesh(data=2, model=1), cfg)  # a model axis of 1 runs as before


@pytest.mark.parametrize("fields,model,match", [
    (dict(num_heads=8, num_kv_heads=2), 3, "query heads 8 do not split"),
    (dict(num_heads=12, num_kv_heads=4, head_dim=8, d_model=60, d_ff=120), 6,
     "4 KV heads and a \"model\" axis of 6 divide neither way"),
    (dict(d_ff=100), 8, "MLP width d_ff 100 do not split"),
    (dict(num_heads=12, num_kv_heads=6, head_dim=4), 4, "6 KV heads and a \"model\" axis of 4 divide neither way"),
])
def test_counts_that_do_not_split_are_refused_by_name(fields, model, match):
    cfg = ranks.tp_config(fields)
    with pytest.raises(ValueError, match=match):
        sharding.refuse_model_axis(_FakeMesh(data=1, model=model), cfg)


def test_the_dense_families_pass():
    for arch in ("granite-3-2b", "yi-9b", "granite-20b", "deepseek-7b", "internvl2-2b", "musicgen-medium"):
        sharding.refuse_model_axis(_FakeMesh(data=1, model=2), treg.get_smoke(arch))
        sharding.refuse_model_axis(_FakeMesh(data=16, model=8), treg.get_config(arch))  # musicgen's 24 heads: 8
    sharding.refuse_model_axis(_FakeMesh(data=1, model=2), treg.get_config("lm-100m"))
