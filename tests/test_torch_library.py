"""The rest of the library against the JAX package: every name of every
JAX package's ``__all__`` is exported by the port's package of the same
path (apart from ``EXCEPTIONS``), and the optimizer transforms,
``partition_stats``, ``global_batch_iterator``, ``hierarchical_mean``,
``describe_all`` and ``kernels.ref`` compute what JAX's do on the same
numpy inputs.

Tolerances: the transforms and ``hierarchical_mean`` are f32 elementwise
math and f32 sums, held to ``rtol=1e-5, atol=1e-6`` (the main path's);
the host numpy ports are held bit for bit."""
import importlib
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import aggregation as jagg
from repro.data import partition as jpart
from repro.data import pipeline as jpipe
from repro.fed import scenarios as jscen
from repro.kernels import ref as jkref
from repro import optim as joptim
from repro_torch.core import aggregation as tagg
from repro_torch.data import partition as tpart
from repro_torch.data import pipeline as tpipe
from repro_torch.fed import scenarios as tscen
from repro_torch.kernels import ref as tkref
from repro_torch import optim as toptim
from repro_torch.testing.parity import assert_close, to_numpy, to_torch

TOL = dict(rtol=1e-5, atol=1e-6)
PACKAGES = ("analysis", "checkpoint", "configs", "core", "data", "dist", "fed", "kernels", "launch", "models",
            "optim", "sim", "testing")
# (package, name): (the port's counterpart, why the port does not export the name)
EXCEPTIONS = {
    ("analysis", "hlo"): ("opcount", "an XLA HLO text parser: the port compiles no XLA; analysis.opcount counts "
                                     "the ops a call dispatches under hlo.py's rules (ROADMAP item 15)"),
}


@pytest.mark.parametrize("package", PACKAGES)
def test_every_jax_export_is_a_port_export(package):
    jmod = importlib.import_module(f"repro.{package}")
    tmod = importlib.import_module(f"repro_torch.{package}")
    missing = [n for n in jmod.__all__ if (package, n) not in EXCEPTIONS
               and not (hasattr(tmod, n) and n in getattr(tmod, "__all__", ()))]
    assert not missing, f"repro_torch.{package} lacks {missing}"
    for (pkg, name), (counterpart, why) in EXCEPTIONS.items():
        if pkg == package:
            assert name in jmod.__all__ and not hasattr(tmod, name), (name, why)
            assert counterpart in tmod.__all__ and hasattr(tmod, counterpart), (counterpart, why)


def test_the_subpackage_list_is_the_jax_package_s():
    import pkgutil

    import repro

    assert sorted(m.name for m in pkgutil.iter_modules(repro.__path__) if m.ispkg) == sorted(PACKAGES)


# -- optimizer transforms -------------------------------------------------------------


def _tree(rng):
    return {"a": rng.normal(size=(3, 4, 5)).astype(np.float32),
            "n": {"b": rng.normal(size=(3, 7)).astype(np.float32)}}


TRANSFORMS = {
    "identity": lambda o: o.identity(),
    "scale": lambda o: o.scale(-0.37),
    "clip_tight": lambda o: o.clip_by_global_norm(0.1),
    "clip_loose": lambda o: o.clip_by_global_norm(1e6),
    "decay": lambda o: o.transforms.add_decayed_weights(0.01),
    "adam_wd": lambda o: o.adam(0.01, weight_decay=0.1),
    "adam": lambda o: o.adam(0.01),
    "adam_sched_wd": lambda o: o.adam(o.exponential_decay(0.05, 0.9, 2), weight_decay=0.02),
    "clip_then_sgd": lambda o: o.chain(o.clip_by_global_norm(0.5), o.sgd(0.1)),
    "scale_by_adam": lambda o: o.scale_by_adam(b1=0.8),
}


@pytest.mark.parametrize("name", sorted(TRANSFORMS))
def test_optimizer_transforms_match_jax(name):
    rng = np.random.default_rng(len(name))
    params = _tree(rng)
    jopt, topt = TRANSFORMS[name](joptim), TRANSFORMS[name](toptim)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    tp = to_torch(params)
    js, ts = jopt.init(jp), topt.init(tp)
    assert len(jax.tree_util.tree_leaves(js)) == len(jax.tree_util.tree_leaves(to_numpy(ts)))
    for _ in range(3):
        grads = _tree(rng)
        ju, js = jopt.update(jax.tree_util.tree_map(jnp.asarray, grads), js, jp)
        tu, ts = topt.update(to_torch(grads), ts, tp)
        assert_close(to_numpy(tu), jax.device_get(ju), what=f"{name} updates", **TOL)
        jp = joptim.apply_updates(jp, ju)
        tp = toptim.apply_updates(tp, tu)
    assert_close(to_numpy(tp), jax.device_get(jp), what=f"{name} params", **TOL)
    assert_close(to_numpy(ts), jax.device_get(js), what=f"{name} state", **TOL)


def test_adam_weight_decay_chains_as_jax_does():
    assert len(toptim.adam(0.1).init({"w": torch.zeros(2)})) == 2
    assert len(toptim.adam(0.1, weight_decay=0.5).init({"w": torch.zeros(2)})) == 3
    with pytest.raises(ValueError, match="requires params"):
        toptim.add_decayed_weights(0.1).update({"w": torch.ones(2)}, toptim.transforms.EmptyState())


# -- data --------------------------------------------------------------------------------


@pytest.mark.parametrize("kind", ["iid", "simple_niid", "edge_iid", "edge_niid"])
def test_partition_stats_match_jax(kind):
    labels = np.random.default_rng(3).integers(0, 10, 2000).astype(np.int32)
    jparts = jpart.partition(kind, labels, 5, 10, np.random.default_rng(9))
    tparts = tpart.partition(kind, labels, 5, 10, np.random.default_rng(9))
    want = jpart.partition_stats(jparts, labels)
    got = tpart.partition_stats(tparts, labels)
    assert got.dtype == want.dtype == np.int64
    np.testing.assert_array_equal(got, want)
    assert got.sum() == sum(len(p) for p in tparts)
    if kind.startswith("edge"):
        assert ((got > 0).sum(axis=1) == 1).all()  # one class a client


@pytest.mark.parametrize("n,batch,seed", [(50, 8, 0), (64, 16, 3), (9, 9, 1)])
def test_global_batch_iterator_matches_jax(n, batch, seed):
    rng = np.random.default_rng(n)
    arrays = {"inputs": rng.normal(size=(n, 3)).astype(np.float32), "targets": np.arange(n, dtype=np.int32)}
    jit, tit = jpipe.global_batch_iterator(arrays, batch, seed=seed), tpipe.global_batch_iterator(
        arrays, batch, seed=seed)
    for _ in range(3 * (n // batch) + 1):  # across epoch boundaries
        jb, tb = next(jit), next(tit)
        assert sorted(jb) == sorted(tb)
        for k in jb:
            np.testing.assert_array_equal(tb[k], jb[k])


# -- hierarchical_mean -----------------------------------------------------------------------


@pytest.mark.parametrize("masked", [False, True, "dead_edge"])
def test_hierarchical_mean_matches_jax_and_the_flat_mean(masked):
    rng = np.random.default_rng(4)
    n, groups = 12, 3
    tree = {"w": rng.normal(size=(n, 4, 3)).astype(np.float32), "n": {"b": rng.normal(size=(n, 5)).astype(np.float32)}}
    weights = rng.integers(1, 9, n).astype(np.float32)
    mask = None
    if masked:
        mask = (rng.random(n) > 0.3).astype(np.float32)
        if masked == "dead_edge":
            mask[4:8] = 0.0
    jm = None if mask is None else jnp.asarray(mask)
    tmask = None if mask is None else torch.from_numpy(mask)
    want = jagg.hierarchical_mean(jax.tree_util.tree_map(jnp.asarray, tree), jnp.asarray(weights), groups, jm)
    got = tagg.hierarchical_mean(to_torch(tree), torch.from_numpy(weights), groups, tmask)
    assert_close(to_numpy(got), jax.device_get(want), what="hierarchical_mean", **TOL)
    flat = tagg.weighted_mean(to_torch(tree), torch.from_numpy(weights), tmask)
    assert_close(to_numpy(got), to_numpy(flat), what="vs weighted_mean", **TOL)


def test_hierarchical_mean_keeps_rows_when_nothing_survives():
    x = {"w": torch.arange(12.0).reshape(4, 3)}
    out = tagg.hierarchical_mean(x, torch.ones(4), 2, torch.zeros(4))
    assert torch.equal(out["w"], x["w"])


# -- scenarios --------------------------------------------------------------------------------


def test_describe_all_is_jax_s():
    rows = tscen.describe_all()
    assert rows == jscen.describe_all()
    assert [n for n, _ in rows] == tscen.names()
    assert all(isinstance(d, str) and d for _, d in rows)


# -- kernels.ref: the plain versions under JAX's oracle names ------------------------------------


def test_kernel_refs_match_jax_s_oracles():
    rng = np.random.default_rng(2)
    x = rng.normal(size=(12, 40)).astype(np.float32)
    w = rng.uniform(0.5, 2.0, 12).astype(np.float32)
    w[3:6] = 0.0  # a dead group / segment
    tx, tw = torch.from_numpy(x), torch.from_numpy(w)
    assert_close(tkref.grouped_mean_ref(tx, tw, 4).numpy(), np.asarray(jkref.grouped_mean_ref(x, w, 4)),
                 what="grouped_mean_ref", **TOL)
    seg = np.array([0, 0, 0, 1, 1, 1, 2, 2, 3, 3, 3, 3])
    assert_close(tkref.segment_mean_ref(tx, tw, seg, 4).numpy(), np.asarray(jkref.segment_mean_ref(x, w, seg, 4)),
                 what="segment_mean_ref", **TOL)
    q, s, shape = tkref.quantize_ref(tx, 64)
    jq, js, jshape = jkref.quantize_ref(x, 64)
    assert tuple(shape) == tuple(jshape) and q.dtype == torch.int8
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    assert_close(s.numpy(), np.asarray(js), what="quantize_ref scales", rtol=2 ** -23, atol=0.0)
    assert_close(tkref.dequantize_ref(q, s, shape).numpy(), np.asarray(jkref.dequantize_ref(jq, js, jshape)),
                 what="dequantize_ref", **TOL)
    codes = rng.integers(-127, 128, size=(12, 64)).astype(np.int8)
    scales = rng.uniform(0.01, 0.1, size=(12, 2)).astype(np.float32)  # qblock 32
    assert_close(tkref.segment_dequant_mean_ref(torch.from_numpy(codes), torch.from_numpy(scales), tw, seg, 4).numpy(),
                 np.asarray(jkref.segment_dequant_mean_ref(codes, scales, w, seg, 4)),
                 what="segment_dequant_mean_ref", **TOL)

    qa = rng.normal(size=(6, 9, 8)).astype(np.float32)
    ka, va = rng.normal(size=(6, 9, 8)).astype(np.float32), rng.normal(size=(6, 9, 8)).astype(np.float32)
    for causal, window in ((True, 0), (True, 3), (False, 0)):
        assert_close(tkref.attention_ref(*(torch.from_numpy(a) for a in (qa, ka, va)), causal=causal,
                                         window=window).numpy(),
                     np.asarray(jkref.attention_ref(qa, ka, va, causal=causal, window=window)),
                     what=f"attention_ref {causal} {window}", **TOL)

    a = rng.uniform(0.5, 1.0, size=(2, 11, 5)).astype(np.float32)
    b, h0 = rng.normal(size=(2, 11, 5)).astype(np.float32), rng.normal(size=(2, 5)).astype(np.float32)
    th, thT = tkref.rglru_scan_ref(*(torch.from_numpy(v) for v in (a, b, h0)))
    jh, jhT = jkref.rglru_scan_ref(*(jnp.asarray(v) for v in (a, b, h0)))
    assert_close(th.numpy(), np.asarray(jh), what="rglru_scan_ref", **TOL)
    assert_close(thT.numpy(), np.asarray(jhT), what="rglru_scan_ref hT", **TOL)

    n, k1, bb, feat, out = 8, 3, 2, 4, 3
    params = (rng.normal(size=(n, feat * out)) * 0.1).astype(np.float32)
    xs, ys = rng.normal(size=(n, k1, bb, feat)).astype(np.float32), rng.normal(size=(n, k1, bb, out)).astype(np.float32)
    ws = rng.uniform(1, 2, n).astype(np.float32)
    got = tkref.edge_interval_ref(*(torch.from_numpy(v) for v in (params, xs, ys, ws)), 2, feat=feat, lr=0.05,
                                  momentum=0.9)
    want = jkref.edge_interval_ref(params, xs, ys, ws, 2, feat=feat, lr=0.05, momentum=0.9)
    assert_close(to_numpy(list(got)), [np.asarray(v) for v in want], what="edge_interval_ref", **TOL)
    assert re.match(r"repro_torch\.kernels\.", tkref.grouped_mean_ref.__module__)
