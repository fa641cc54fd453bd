"""The port's aggregation operators against the JAX operators, and K1/K2's
plain versions against the JAX kernels' oracles and interpret-mode Pallas
kernels, on the same numpy inputs.

Tolerances: f32 ``rtol=1e-6, atol=1e-6`` — the same f32 arithmetic summed
in a possibly different order, a few ulp apart at most. bf16 storage
``atol=5e-2`` as ``tests/test_kernels.py`` (one bf16 ulp at |x| ~ 4, where
the two f32 means may round to neighbouring bf16 values). Dead groups are
held bit for bit.
"""
import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import aggregation as jagg
from repro.core.hierarchy import parse_fanouts as jparse
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.core import aggregation as tagg
from repro_torch.core.hierarchy import parse_fanouts as tparse
from repro_torch.kernels import hier_aggregate as ha
from repro_torch.kernels import ops as tops
from repro_torch.testing.parity import assert_close, to_numpy, to_torch

jops.set_interpret(True)  # Pallas kernels in interpret mode, as tests/test_kernels.py

F32 = dict(rtol=1e-6, atol=1e-6)
BF16 = dict(rtol=0.0, atol=5e-2)
TREES = {
    "uniform": "5,5,5,5/4",
    "ragged": "16,12,10,7,5/5",
    "depth3": "10,10,10,10,10/3,2/2",
}


def _tree(rng, n, dtype=np.float32):
    return {
        "w": rng.normal(size=(n, 3, 4)).astype(dtype),
        "b": rng.normal(size=(n, 7)).astype(dtype),
        "s": rng.normal(size=(n,)).astype(dtype),
    }


def _masks(rng, spec, kind):
    n = spec.num_clients
    if kind == "none":
        return None
    m = (rng.random(n) > 0.3).astype(np.float32)
    if kind == "dead_group":
        m[spec.segments(1) == 0] = 0.0  # every member of edge 0 dead
    return m


def _jax(tree, dtype=jnp.float32):
    return {k: jnp.asarray(v, dtype) for k, v in tree.items()}


def _both(rng, spec, dtype="float32", mask_kind="none"):
    tree = _tree(rng, spec.num_clients)
    w = rng.uniform(20.0, 80.0, spec.num_clients).astype(np.float32)
    mask = _masks(rng, spec, mask_kind)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    jt = _jax(tree, jdt)
    tt = {k: torch.from_numpy(v).to(getattr(torch, dtype)) for k, v in tree.items()}
    jm = None if mask is None else jnp.asarray(mask)
    tm = None if mask is None else torch.from_numpy(mask)
    return (jt, jnp.asarray(w), jm), (tt, torch.from_numpy(w), tm), mask


def _compare(jout, tout, what, dtype="float32"):
    got = to_numpy(tout)
    want = {k: np.asarray(jnp.asarray(v, jnp.float32)) for k, v in jout.items()}
    assert_close(got, want, what=what, **(F32 if dtype == "float32" else BF16))


@pytest.mark.parametrize("tree", sorted(TREES))
@pytest.mark.parametrize("mask_kind", ["none", "random", "dead_group"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_hierarchical_segment_mean_every_level(tree, mask_kind, dtype):
    rng = np.random.default_rng(zlib.crc32(f"{tree}/{mask_kind}/{dtype}".encode()))
    jspec, tspec = jparse(TREES[tree]), tparse(TREES[tree])
    (jt, jw, jm), (tt, tw, tm), mask = _both(rng, jspec, dtype, mask_kind)
    for level in range(1, jspec.depth + 1):
        jout = jagg.hierarchical_segment_mean(jt, jw, jspec, level, jm)
        tout = tagg.hierarchical_segment_mean(tt, tw, tspec, level, tm)
        _compare(jout, tout, f"{tree} level {level} {mask_kind} {dtype}", dtype)
        assert all(tout[k].dtype == tt[k].dtype for k in tt)
        if mask_kind == "dead_group" and level == 1:
            dead = tspec.segments(1) == 0
            for k in tt:  # no survivors: rows kept bit for bit
                assert torch.equal(tout[k][dead], tt[k][dead])


@pytest.mark.parametrize("tree", sorted(TREES))
@pytest.mark.parametrize("mask_kind", ["none", "dead_group"])
def test_segment_weighted_mean_per_level(tree, mask_kind):
    rng = np.random.default_rng(5)
    jspec, tspec = jparse(TREES[tree]), tparse(TREES[tree])
    (jt, jw, jm), (tt, tw, tm), _ = _both(rng, jspec, "float32", mask_kind)
    for level in range(1, jspec.depth + 1):
        ids, g = tspec.segments(level), tspec.num_nodes(level)
        jout = jagg.segment_weighted_mean(jt, jw, jspec.segments(level), g, jm)
        tout = tagg.segment_weighted_mean(tt, tw, ids, g, tm)
        _compare(jout, tout, f"segment_weighted_mean {tree} level {level}")
        assert_close(
            to_numpy(tagg.segment_weights(tw, ids, g, tm)),
            np.asarray(jagg.segment_weights(jw, jspec.segments(level), g, jm)),
            what="segment_weights", **F32,
        )


@pytest.mark.parametrize("groups", [1, 2, 4, 20])
@pytest.mark.parametrize("mask_kind", ["none", "random", "dead_group"])
def test_grouped_weighted_mean(groups, mask_kind):
    rng = np.random.default_rng(groups)
    spec = jparse("5,5,5,5/4")
    (jt, jw, jm), (tt, tw, tm), _ = _both(rng, spec, "float32", mask_kind)
    jout = jagg.grouped_weighted_mean(jt, jw, groups, jm)
    tout = tagg.grouped_weighted_mean(tt, tw, groups, tm)
    _compare(jout, tout, f"grouped_weighted_mean G={groups}")
    assert_close(
        to_numpy(tagg.group_weights(tw, groups, tm)), np.asarray(jagg.group_weights(jw, groups, jm)),
        what="group_weights", **F32,
    )


def test_grouped_weighted_mean_rejects_uneven_groups():
    with pytest.raises(ValueError, match="not divisible"):
        tagg.grouped_weighted_mean({"x": torch.zeros(6, 2)}, torch.ones(6), 4)


@pytest.mark.parametrize("mask_kind", ["none", "random", "all_dead"])
def test_weighted_mean_and_cloud_model(mask_kind):
    rng = np.random.default_rng(9)
    spec = jparse("5,5,5,5/4")
    (jt, jw, jm), (tt, tw, tm), _ = _both(rng, spec, "float32", "none" if mask_kind == "all_dead" else mask_kind)
    if mask_kind == "all_dead":
        jm, tm = jnp.zeros(20), torch.zeros(20)
    _compare(jagg.weighted_mean(jt, jw, jm), tagg.weighted_mean(tt, tw, tm), "weighted_mean")
    _compare(jagg.cloud_model(jt, jw, jm), tagg.cloud_model(tt, tw, tm), "cloud_model")


def test_staged_cloud_equals_flat_weighted_mean():
    """The staged cloud sync equals the flat mean (weights compose)."""
    rng = np.random.default_rng(2)
    tspec = tparse("16,12,10,7,5/5")
    tt = to_torch(_tree(rng, 50))
    tw = torch.from_numpy(rng.uniform(20, 80, 50).astype(np.float32))
    assert_close(
        tagg.hierarchical_segment_mean(tt, tw, tspec), tagg.weighted_mean(tt, tw),
        what="staged vs flat", rtol=1e-5, atol=1e-6,
    )


# -- K1 / K2 plain versions against the JAX kernels' oracles -------------------


def _xw(rng, n, d, dead_first=0, dtype=np.float32):
    x = rng.normal(size=(n, d)).astype(dtype)
    w = rng.uniform(0.5, 4.0, n).astype(np.float32)
    w[:dead_first] = 0.0
    return x, w


@pytest.mark.parametrize("n,groups", [(4, 2), (8, 4), (20, 4), (32, 1), (32, 8)])
@pytest.mark.parametrize("d", [64, 513])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_grouped_mean_plain_vs_ref_and_pallas(n, groups, d, dtype):
    rng = np.random.default_rng(n * d)
    x, w = _xw(rng, n, d, dead_first=n // groups if groups > 1 else 0)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    jx, jw = jnp.asarray(x, jdt), jnp.asarray(w)
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    got = ha.grouped_mean_plain(tx, torch.from_numpy(w), groups)
    assert got.dtype == tx.dtype
    tol = F32 if dtype == "float32" else BF16
    want = np.asarray(jnp.asarray(jref.grouped_mean_ref(jx, jw, groups), jnp.float32))
    assert_close(to_numpy(got), want, what="grouped_mean_plain vs ref", **tol)
    pallas = np.asarray(jnp.asarray(jops.grouped_mean(jx, jw, groups, block_d=128), jnp.float32))
    assert_close(to_numpy(got), pallas, what="grouped_mean_plain vs pallas", **tol)
    assert_close(to_numpy(tops.grouped_mean(tx, torch.from_numpy(w), groups)), want, what="ops", **tol)
    if groups > 1:  # the dead first group keeps its rows exactly
        assert torch.equal(got[: n // groups], tx[: n // groups])


@pytest.mark.parametrize("sizes", [(3, 5, 2), (16, 12, 10, 7, 5), (1, 1, 6), (4, 4, 4)])
@pytest.mark.parametrize("d", [64, 513])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_segment_mean_plain_vs_ref_and_pallas(sizes, d, dtype):
    rng = np.random.default_rng(sum(sizes) * d)
    ids = np.repeat(np.arange(len(sizes)), sizes).astype(np.int32)
    n, g = ids.size, len(sizes)
    x, w = _xw(rng, n, d, dead_first=sizes[0])
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    jx, jw = jnp.asarray(x, jdt), jnp.asarray(w)
    tx, tw = torch.from_numpy(x).to(getattr(torch, dtype)), torch.from_numpy(w)
    got = ha.segment_mean_plain(tx, tw, ids, g)
    tol = F32 if dtype == "float32" else BF16
    want = np.asarray(jnp.asarray(jref.segment_mean_ref(jx, jw, ids, g), jnp.float32))
    assert_close(to_numpy(got), want, what="segment_mean_plain vs ref", **tol)
    pallas = np.asarray(jnp.asarray(jops.segment_mean(jx, jw, ids, g), jnp.float32))
    assert_close(to_numpy(got), pallas, what="segment_mean_plain vs pallas", **tol)
    assert_close(to_numpy(tops.segment_mean(tx, tw, ids, g)), pallas, what="ops.segment_mean", **tol)
    assert_close(to_numpy(ha.segment_mean(tx, tw, ids, g)), want, what="wrapper on cpu", **tol)
    assert torch.equal(got[: sizes[0]], tx[: sizes[0]])  # dead first segment kept


def test_static_uniform_groups_matches_jax():
    for ids, g in [([0, 0, 1, 1], 2), ([0, 0, 0, 1], 2), ([0, 1, 2], 3), ([0, 0, 1, 1, 2, 2], 2)]:
        assert tagg._static_uniform_groups(np.array(ids), g) == jagg._static_uniform_groups(np.array(ids), g)


@pytest.mark.parametrize("tree", sorted(TREES))
def test_level_stages_pick_k1_for_equal_blocks_and_k2_for_ragged(tree):
    spec = tparse(TREES[tree])
    assert len(tagg.level_stages(spec)) == spec.depth  # level=None: the cloud
    for level in range(1, spec.depth + 1):
        stages = tagg.level_stages(spec, level)
        assert [s.uniform for s in stages] == [spec.is_uniform(t) for t in range(1, level + 1)]
        for t, st in enumerate(stages, 1):
            assert st.num_segments == spec.num_nodes(t) and st.ids.dtype == np.int64
            np.testing.assert_array_equal(st.ids, spec.segments(t))
