"""Sampled participation in the port against the JAX package, on the CPU.

- ``build_cohort_super_round`` against JAX's on a ragged and a uniform tree,
  with sgd, momentum with ``sync_opt_state`` and int8 error feedback on
  both hops, with and without a (kappa2, C) survival mask stack, over two
  cloud intervals with different cohorts, from the same params (the JAX
  init carried across). Tolerance ``rtol=1e-5``, ``atol=1e-6``, the engine
  tests' (``tests/test_torch_hierfavg.py``).
- The identity cohort (C = N, the whole population in order) against the
  port's own superround, and a round-robin cohort run against the plain
  runner: bit for bit (the stages are the full tree's, so the same K1/K2
  route runs; JAX promises one ulp here).
- The runner on an ``n1m_cohort4096``-shaped run at small size (128 virtual
  clients on 8 edges, stratified cohorts of 32): per-round loss and
  grad_norm ``rtol=1e-4``, final params ``atol=1e-5``, ``num_touched``
  equal; a cut-and-resumed run bit-equal to the straight one, store
  included; JAX's refusals in JAX's words.
- K2's offsets table compacted to the segments a cohort holds gives the
  plain means (on the card: ``tests/test_torch_kernels.py``, which imports
  no jax, runs a cohort sync over 70,000 nodes through K2).
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import hierfavg as jh
from repro.core.hierarchy import parse_fanouts as jparse
from repro.fed import api as japi
from repro.fed import participation as jp
from repro.fed import scenarios as jscen
from repro.fed import transport as jtransport
from repro import optim as joptim
from repro_torch.core import aggregation
from repro_torch.core import hierfavg as th
from repro_torch.core.hierarchy import HierarchySpec
from repro_torch.core.hierarchy import parse_fanouts as tparse
from repro_torch.data.pipeline import CohortPrefetcher, VirtualClientBatcher
from repro_torch.fed import api as tapi
from repro_torch.fed import participation as tp
from repro_torch.fed import scenarios as tscen
from repro_torch.fed import transport as ttransport
from repro_torch.kernels import hier_aggregate as ha
from repro_torch import optim as toptim
from repro_torch.testing.parity import assert_close, to_numpy
from repro_torch.tree import leaves

TOL = dict(rtol=1e-5, atol=1e-6)
DIM, HIDDEN, CLASSES, BATCH = 6, 8, 4, 3
MODEL = [f"data.dim={DIM}", f"model.hidden={HIDDEN}", f"data.num_classes={CLASSES}"]
# n1m_cohort4096 cut to 128 virtual clients on 8 edges of 16, stratified
# cohorts of 32 (4 per edge), 4 rounds (2 cloud intervals)
SMALL_N1M = ["topology.num_edges=8", "topology.clients_per_edge=16", "data.virtual_clients=128",
             "participation.cohort_size=32", "run.num_rounds=4", "run.eval_every=2"]


def _models():
    jspec, tspec = japi.ExperimentSpec.parse(MODEL), tapi.ExperimentSpec.parse(MODEL)
    np_params = jax.device_get(jspec.init_params(jax.random.PRNGKey(1)))
    return (japi._model_bundle(jspec), jax.tree_util.tree_map(jnp.asarray, np_params),
            tspec.model_bundle("cpu"), tspec.params_from_numpy(np_params, "cpu"))


def _opts(kind):
    if kind == "momentum_sync":
        return joptim.momentum(0.05, 0.9), toptim.momentum(0.05, 0.9), dict(sync_opt_state=True)
    if kind == "int8_ef":
        t = "int8_ef:64/int8_ef:64"
        return joptim.sgd(0.1), toptim.sgd(0.1), dict(transport=t)
    return joptim.sgd(0.1), toptim.sgd(0.1), {}


def _configs(kappas, cfg):
    cfg = dict(cfg)
    t = cfg.pop("transport", None)
    jcfg = jh.HierFAVGConfig.multi_level(kappas, transport=t and jtransport.TransportSpec.parse(t), **cfg)
    tcfg = th.HierFAVGConfig.multi_level(kappas, transport=t and ttransport.TransportSpec.parse(t), **cfg)
    return jcfg, tcfg


def _batches(rng, lead):
    return {"inputs": rng.normal(size=lead + (BATCH, DIM)).astype(np.float32),
            "targets": rng.integers(0, CLASSES, size=lead + (BATCH,)).astype(np.int32)}


def _tleaves(tree):
    return [x for x in leaves(tree) if x is not None]


def _segments_table(spec, ids):
    return np.stack([np.asarray(spec.segments(lvl), np.int32) for lvl in range(1, spec.depth)])[:, ids]


@pytest.mark.parametrize("masked", [False, True], ids=["unmasked", "masked"])
@pytest.mark.parametrize("opt", ["sgd", "momentum_sync", "int8_ef"])
@pytest.mark.parametrize("tree", ["5,4,3/3", "4,4,4/3"])
def test_cohort_super_round_matches_jax(tree, opt, masked):
    jb, jparams, tb, tparams = _models()
    jopt, topt, cfg = _opts(opt)
    kappas, c = (2, 2), 7
    jcfg, tcfg = _configs(kappas, cfg)
    jspec, tspec = jparse(tree), tparse(tree)
    n = jspec.num_clients
    js = jh.init_cohort_state(jax.random.PRNGKey(0), jparams, jopt, jcfg, c)
    ts = th.init_cohort_state(torch.Generator().manual_seed(0), tparams, topt, tcfg, c)
    jfn = jax.jit(jh.build_cohort_super_round(jb["loss"], jopt, jspec, jcfg, cohort_size=c))
    tfn = th.build_cohort_super_round(tb["loss"], topt, tspec, tcfg, cohort_size=c)
    rng = np.random.default_rng(5)
    weights = rng.uniform(1.0, 5.0, size=n).astype(np.float32)
    sampler = jp.UniformSampler(n, c, seed=2)
    for interval in range(2):
        ids = sampler.sample()
        batches = _batches(rng, kappas[::-1] + (c,))
        cohort = {"segments": _segments_table(jspec, ids), "weights": weights[ids]}
        masks = None
        if masked:
            masks = (rng.random((2, c)) > 0.3).astype(np.float32)
            edge0 = np.asarray(jspec.segments(1))[ids] == np.asarray(jspec.segments(1))[ids][0]
            masks[1, edge0] = 0.0  # a whole edge of the cohort dies at the cloud round
        js, jm = jfn(js, {k: jnp.asarray(v) for k, v in batches.items()},
                     {k: jnp.asarray(v) for k, v in cohort.items()}, None if masks is None else jnp.asarray(masks))
        ts, tm = tfn(ts, {k: torch.from_numpy(v) for k, v in batches.items()}, cohort,
                     None if masks is None else torch.from_numpy(masks))
        what = f"{tree} {opt} interval {interval}"
        assert_close(to_numpy(tm), jax.device_get(jm), what=f"{what} metrics", **TOL)
        assert_close(to_numpy(ts.params), jax.device_get(js.params), what=f"{what} params", **TOL)
        assert_close(to_numpy(_tleaves(ts.opt_state)), [np.asarray(x) for x in jax.tree_util.tree_leaves(js.opt_state)],
                     what=f"{what} opt", **TOL)
        if opt == "int8_ef":
            assert_close(to_numpy(ts.anchor), jax.device_get(js.anchor), what=f"{what} anchor", **TOL)
            assert_close(to_numpy(ts.residual), jax.device_get(js.residual), what=f"{what} residual", **TOL)


@pytest.mark.parametrize("masked", [False, True], ids=["unmasked", "masked"])
@pytest.mark.parametrize("tree,kappas,opt", [
    ("5,4,3/3", (2, 2), "sgd"), ("4,4,4/3", (3, 2), "int8_ef"), ("3,2,3,2/2,2/2", (2, 2, 2), "momentum_sync")])
def test_identity_cohort_is_the_superround_bit_for_bit(tree, kappas, opt, masked):
    """C = N with the population's own ids, weights and masks: the cohort
    stages are the full tree's, so every op is the superround's."""
    _, _, tb, tparams = _models()
    _, topt, cfg = _opts(opt)
    _, tcfg = _configs(kappas, cfg)
    spec = tparse(tree)
    n = spec.num_clients
    rng = np.random.default_rng(1)
    weights = rng.uniform(1.0, 5.0, size=n).astype(np.float32)
    full = th.build_super_round(tb["loss"], topt, spec, tcfg, torch.from_numpy(weights))
    cohort_fn = th.build_cohort_super_round(tb["loss"], topt, spec, tcfg, cohort_size=n)
    ref = th.init_state(torch.Generator().manual_seed(0), tparams, topt, spec, tcfg)
    got = th.init_cohort_state(torch.Generator().manual_seed(0), tparams, topt, tcfg, n)
    ids = np.arange(n)
    for _ in range(2):
        k2 = tcfg.kappa2_effective
        batches = {k: torch.from_numpy(v) for k, v in _batches(rng, (k2, kappas[0], n)).items()}
        masks = torch.from_numpy((rng.random((k2, n)) > 0.25).astype(np.float32)) if masked else None
        ref, rm = full(ref, batches, masks)
        got, gm = cohort_fn(got, batches, {"segments": _segments_table(spec, ids), "weights": weights}, masks)
        for a, b in zip(_tleaves((gm, got.params, got.opt_state, got.anchor, got.residual)),
                        _tleaves((rm, ref.params, ref.opt_state, ref.anchor, ref.residual))):
            assert torch.equal(a, b)


def test_cohort_stages_compact_and_route_like_the_full_tree():
    spec = tparse("5,4,3/3")
    # the whole population: the full tree's stages
    full = aggregation.cohort_stages(_segments_table(spec, np.arange(12)), 12)
    for st, ref in zip(full, aggregation.level_stages(spec)):
        np.testing.assert_array_equal(st.ids, ref.ids)
        assert (st.num_segments, st.uniform) == (ref.num_segments, ref.uniform)
    # a cohort that misses edge 1: two segments left, equal blocks -> K1
    st = aggregation.cohort_stages(np.array([[0, 0, 2, 2]]), 4)
    np.testing.assert_array_equal(st[0].ids, [0, 0, 1, 1])
    assert st[0].num_segments == 2 and st[0].uniform and st[1].uniform and st[1].num_segments == 1
    # ragged -> K2 with the compacted table
    st = aggregation.cohort_stages(np.array([[1, 1, 1, 4, 9]]), 5)
    assert st[0].num_segments == 3 and not st[0].uniform
    off, ids = aggregation.stage_host_tables(st[0])
    np.testing.assert_array_equal(off, [0, 3, 4, 5])
    assert off.dtype == np.int32 and aggregation.stage_host_tables(st[1])[0] is None


def _mean_from_offsets(x, w, offsets):
    """What K2 computes from its table: each segment's rows
    [offsets[g], offsets[g+1]) summed in order, the mean written back, a
    zero-weight segment kept."""
    out = x.clone()
    for g in range(len(offsets) - 1):
        lo, hi = int(offsets[g]), int(offsets[g + 1])
        num, den = torch.zeros(x.shape[1], dtype=torch.float64), 0.0
        for i in range(lo, hi):
            num += x[i].double() * float(w[i])
            den += float(w[i])
        if den > 0:
            out[lo:hi] = (num / den).float()
    return out


@pytest.mark.parametrize("sampler", ["uniform", "stratified"])
def test_compacted_offsets_give_the_plain_means(sampler):
    """The compacted table over the segments present gives the plain
    version's means over the original node ids (70 edges, most empty under
    a small uniform cohort), with masked members and a dead segment."""
    spec = HierarchySpec.uniform(70, 5)
    c = 80 if sampler == "stratified" else 24
    ids = tp.build_sampler(tp.ParticipationSpec(cohort_size=c, sampler=sampler, seed=3), spec).sample()
    orig = np.asarray(spec.segments(1))[ids]
    (st, top) = aggregation.cohort_stages(orig[None], c)
    assert st.num_segments == np.unique(orig).shape[0] <= c and top.num_segments == 1
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.normal(size=(c, 33)).astype(np.float32))
    w = torch.from_numpy(rng.uniform(0.5, 2.0, size=c).astype(np.float32))
    w[orig == orig[0]] = 0.0  # the first segment is dead
    w[3] = 0.0
    want = ha.segment_mean_plain(x, w, orig, spec.num_nodes(1))
    offsets = ha.segment_offsets(st.ids, st.num_segments)
    torch.testing.assert_close(_mean_from_offsets(x, w, offsets), want, rtol=1e-6, atol=1e-6)
    got = ha.segment_mean(x, w, st.ids, st.num_segments, offsets=torch.from_numpy(offsets))
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)
    assert torch.equal(got[orig == orig[0]], x[orig == orig[0]])


def test_cohort_prefetcher_draws_jax_cohorts_and_builds_their_stages():
    pool = {"inputs": np.random.default_rng(0).normal(size=(200, DIM)).astype(np.float32),
            "targets": np.zeros(200, np.int32)}
    spec = tparse("5,4,3/3")
    table = np.stack([np.asarray(spec.segments(1), np.int32)])
    weights = np.arange(1, 13, dtype=np.float32)
    batcher = VirtualClientBatcher(pool, num_clients=12, samples_per_client=8, batch_size=2, seed=1)
    ref_batcher = VirtualClientBatcher(pool, num_clients=12, samples_per_client=8, batch_size=2, seed=1)
    ref_sampler = jp.StratifiedSampler(12, 6, np.asarray(spec.segments(1)), seed=4)
    pf = CohortPrefetcher(batcher, tp.StratifiedSampler(12, 6, np.asarray(spec.segments(1)), seed=4),
                          segments=table, weights=weights, rounds_per_block=2, steps_per_round=3,
                          device=torch.device("cpu"), num_blocks=3)
    try:
        for _ in range(3):
            ids, cohort, block = pf.get()
            want = ref_sampler.sample()
            np.testing.assert_array_equal(ids, want)
            flat = ref_batcher.next_batches_for(want, 6)
            np.testing.assert_array_equal(block["inputs"].numpy(), flat["inputs"].reshape((2, 3) + flat["inputs"].shape[1:]))
            assert torch.equal(cohort["weights"], torch.from_numpy(weights[want]))
            for st, ref in zip(cohort["stages"], aggregation.cohort_stages(table[:, want], 6)):
                np.testing.assert_array_equal(st.ids, ref.ids)
                assert st.device_ids is not None and (st.offsets is None) == st.uniform
            assert pf.snapshot == {"batcher": ref_batcher.state_dict(), "sampler": ref_sampler.state_dict()}
        with pytest.raises(RuntimeError, match="exhausted"):
            pf.get()
    finally:
        pf.stop()


# -- the runner ------------------------------------------------------------------


def _run_both(name, overrides):
    jspec, tspec = jscen.get(name, overrides=overrides), tscen.get(name, overrides=overrides)
    np_params = jax.device_get(jspec.init_params(jax.random.PRNGKey(jspec.run.seed + 1)))
    jr, js = jspec.run_experiment()
    tr, ts = tspec.run_experiment(device="cpu", params=tspec.params_from_numpy(np_params, "cpu"))
    return (jr, js), (tr, ts)


@pytest.mark.parametrize("extra", [
    [],
    ["model.optimizer=adam", "model.lr=0.01", "transport.levels=int8_ef:64/int8_ef:64"],
    ["participation.sampler=uniform", "failures.p_fail=0.2", "failures.straggler_sigma=0.3"],
], ids=["stratified_sgd", "adam_int8_ef", "uniform_failures"])
def test_population_runner_tracks_jax(extra):
    (jr, js), (tr, ts) = _run_both("n1m_cohort4096", SMALL_N1M + extra)
    assert len(tr.history) == len(jr.history) == 4
    for a, b in zip(jr.history, tr.history):
        assert (b.round, b.step, b.mask_alive) == (a.round, a.step, a.mask_alive)
        assert b.loss == pytest.approx(a.loss, rel=1e-4), f"round {a.round} loss"
        assert b.grad_norm == pytest.approx(a.grad_norm, rel=1e-4), f"round {a.round} grad_norm"
        assert (a.accuracy is None) == (b.accuracy is None)
        if a.accuracy is not None:
            assert abs(b.accuracy - a.accuracy) <= 0.01
        assert b.wire_mb == pytest.approx(a.wire_mb, rel=1e-12)
    assert_close(to_numpy(ts.params), jax.device_get(js.params), rtol=0.0, atol=1e-5, what="final params")
    assert all(v.shape[0] == 32 for v in ts.params.values())
    assert tr.client_store.num_touched == jr.client_store.num_touched
    assert tr._cohort_sampler().state_dict() == jr._cohort_sampler().state_dict()
    assert json.loads(json.dumps(tr.batcher.state_dict())) == json.loads(json.dumps(jr.batcher.state_dict()))


@pytest.mark.parametrize("name,overrides", [
    ("quickstart", ["participation.cohort_size=20", "participation.sampler=round_robin", "run.num_rounds=8",
                    "run.eval_every=2"]),
    ("ragged_edges", ["participation.cohort_size=50", "participation.sampler=round_robin", "run.num_rounds=20",
                      "run.eval_every=10", "failures.p_fail=0.1"]),
])
def test_full_population_cohort_run_is_the_plain_run_bit_for_bit(name, overrides):
    spec = tscen.get(name, overrides=overrides)
    plain = tscen.get(name, overrides=[o for o in overrides if not o.startswith("participation.")])
    params = spec.init_params(1, "cpu")
    r, s = spec.run_experiment(device="cpu", params={k: v.clone() for k, v in params.items()})
    r0, s0 = plain.run_experiment(device="cpu", params={k: v.clone() for k, v in params.items()})
    fields = lambda h: (h.round, h.step, h.loss, h.grad_norm, h.mask_alive, h.accuracy, h.wire_mb)
    assert [fields(h) for h in r.history] == [fields(h) for h in r0.history]
    assert all(torch.equal(s.params[k], s0.params[k]) for k in s.params)


def test_resumed_cohort_run_is_the_straight_run_bit_for_bit(tmp_path):
    ov = ["topology.num_edges=4", "topology.clients_per_edge=16", "data.virtual_clients=64",
          "participation.cohort_size=8", "participation.sampler=uniform", "run.num_rounds=8", "run.eval_every=2",
          "model.optimizer=adam", "model.lr=0.01", "transport.levels=int8_ef:64/int8_ef:64", "failures.p_fail=0.2"]
    params = tscen.get("n1m_cohort4096", overrides=ov).init_params(1, "cpu")
    clone = lambda: {k: v.clone() for k, v in params.items()}
    straight, s = tscen.get("n1m_cohort4096", overrides=ov).run_experiment(device="cpu", params=clone())
    ck = [f"run.checkpoint_dir={tmp_path}", "run.checkpoint_every=4"]
    tscen.get("n1m_cohort4096", overrides=ov + ck + ["run.num_rounds=4"]).run_experiment(device="cpu", params=clone())
    meta = json.loads((tmp_path / "step_000000000016" / "meta.json").read_text())["user"]
    assert sorted(meta) == ["batcher", "failures", "round", "sampler"] and meta["round"] == 4
    resumed, rs = tscen.get("n1m_cohort4096", overrides=ov + ck).run_experiment(device="cpu", params=clone(),
                                                                                 resume=True)
    fields = lambda h: (h.round, h.step, h.loss, h.grad_norm, h.mask_alive, h.accuracy)
    assert [h.round for h in resumed.history] == [4, 5, 6, 7]
    assert [fields(h) for h in resumed.history] == [fields(h) for h in straight.history[4:]]
    assert all(torch.equal(rs.params[k], s.params[k]) for k in s.params)
    a, b = straight.client_store.state(), resumed.client_store.state()
    assert all(np.array_equal(x, y) for x, y in zip(a["leaves"], b["leaves"]))
    assert np.array_equal(a["touched"], b["touched"]) and straight.client_store.num_touched > 8


@pytest.mark.parametrize("overrides,error", [
    (["run.engine=per_round"], "sampled participation cannot run: engine='per_round' has no cohort lowering"),
    (["run.eval_every=1"], "eval_every=1 is finer than a cloud interval (kappa2_eff=2)"),
    (["run.checkpoint_every=3", "run.checkpoint_dir=ckpt"], "checkpoint_every=3 is finer than a cloud interval"),
    (["run.num_rounds=3"], "num_rounds 3 is not a whole number of cloud intervals"),
    (["participation.cohort_size=4"], "stratified sampling needs cohort_size >= num_edges (4 < 8)"),
])
def test_runs_the_cohort_engine_cannot_take_are_refused_in_jax_words(overrides, error, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    for scen, kw in ((jscen, {}), (tscen, {"device": "cpu"})):
        with pytest.raises(ValueError) as err:
            scen.get("n1m_cohort4096", overrides=SMALL_N1M + overrides).run_experiment(**kw)
        assert error in str(err.value)


def test_robust_aggregators_and_other_specs_are_refused_like_jax():
    robust = SMALL_N1M + ["aggregators.levels=trimmed_mean:0.1/weighted_mean"]
    for scen, kw in ((jscen, {}), (tscen, {"device": "cpu"})):
        with pytest.raises(ValueError, match="requires the default weighted mean at every level"):
            scen.get("n1m_cohort4096", overrides=robust).build(**kw)
        with pytest.raises(ValueError, match="must equal the topology's 128 clients"):
            scen.get("n1m_cohort4096", overrides=SMALL_N1M + ["data.virtual_clients=100"]).build(**kw)
    with pytest.raises(TypeError, match="ParticipationSpec"):
        th.HierFAVGConfig(kappa1=2, kappa2=2, participation=4)
    part = tp.ParticipationSpec(cohort_size=4)
    cfg = th.HierFAVGConfig(kappa1=2, kappa2=2, participation=part)
    jcfg = jh.HierFAVGConfig(kappa1=2, kappa2=2, participation=jp.ParticipationSpec(cohort_size=4))
    assert cfg.participation_active and jcfg.participation_active
    assert not th.HierFAVGConfig(kappa1=2, kappa2=2, participation=tp.ParticipationSpec()).participation_active
    reason = th.megakernel_incompatibility(cfg, tparse("4,4/2"))
    assert reason == jh.megakernel_incompatibility(jcfg, jparse("4,4/2")) == (
        "sampled participation runs through the cohort engine")
    assert th.cohort_incompatibility(cfg, tparse("4,4/2"), 9) == jh.cohort_incompatibility(jcfg, jparse("4,4/2"), 9)
    with pytest.raises(ValueError, match="schedule cannot run cohort-sampled"):
        th.build_cohort_super_round(None, toptim.sgd(0.1), tparse("4,4/2"), cfg, cohort_size=0)


def test_the_population_scenario_builds_like_jax():
    tspec, jspec = tscen.get("n1m_cohort4096"), jscen.get("n1m_cohort4096")
    assert tspec.describe() == jspec.describe()
    assert "cohort=4096/stratified" in tspec.describe()
    runner = tspec.build(device="cpu")
    assert runner.participation.cohort_size == 4096 and runner._round is None
    assert isinstance(runner.batcher, VirtualClientBatcher) and runner.batcher.num_clients == 1_000_000
    state = runner.init(torch.Generator().manual_seed(0), tspec.init_params(1, "cpu"))
    assert all(v.shape[0] == 4096 for v in state.params.values())


@pytest.mark.population
def test_population_run_keeps_device_state_cohort_sized():
    """``n1m_cohort4096`` uncut for one cloud interval on the CPU: every
    stacked leaf holds the 4096 sampled clients, the loss is finite."""
    runner, state = tscen.get("n1m_cohort4096", overrides=["run.num_rounds=2"]).run_experiment(device="cpu")
    assert all(v.shape[0] == 4096 for v in state.params.values())
    assert len(runner.history) == 2 and all(np.isfinite(h.loss) for h in runner.history)
