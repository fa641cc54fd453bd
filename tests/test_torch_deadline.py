"""The port's semi-synchronous deadline engine against the JAX package's
(``repro.fed.deadline``, ``repro.core.hierfavg.build_deadline_super_round``,
``repro.fed.engine.DeadlineEngine``).

The scheduler is host numpy in both packages, so its staleness weights,
cadences and plans are held to JAX bit for bit. The gated superround is
held on one interval from the same state, batches, gate and masks at the
superround tests' tolerance (``rtol=1e-5``, ``atol=1e-6``), and the
registered deadline scenarios at the runner tests' (per-round loss
``rel=1e-4``, accuracy within 0.01, final params ``atol=1e-4``), with
``wall_clock_s`` exactly equal: the event clock is host arithmetic on the
same draws. Within the port the barrier configuration and a resumed run
are bit-equal to their references.
"""
import dataclasses
import json
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import manager as jmanager
from repro.core import hierfavg as jh
from repro.core.hierarchy import parse_fanouts as jparse
from repro.fed import api as japi
from repro.fed import deadline as jdl
from repro.fed import failures as jfail
from repro.fed import scenarios as jscen
from repro import optim as joptim
from repro_torch.checkpoint import manager as tmanager
from repro_torch.core import hierfavg as th
from repro_torch.core.hierarchy import parse_fanouts as tparse
from repro_torch.fed import api as tapi
from repro_torch.fed import deadline as tdl
from repro_torch.fed import failures as tfail
from repro_torch.fed import scenarios as tscen
from repro_torch.fed.engine import DeadlineEngine, SuperRoundEngine
from repro_torch import optim as toptim
from repro_torch.testing.parity import assert_close, to_numpy

TOL = dict(rtol=1e-5, atol=1e-6)
DEADLINE_SCENARIOS = ["deadline_straggler", "fedbuff_k4", "stale_decay"]
RUN_20 = ["run.num_rounds=20", "run.eval_every=10"]


def _plans_equal(a, b):
    assert a._fields == b._fields
    for name, x, y in zip(a._fields, a, b):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y), err_msg=name)
        assert np.asarray(x).dtype == np.asarray(y).dtype, name
    assert a.is_trivial == b.is_trivial


# ---------------------------------------------------------------------------
# Staleness, cadences, the scheduler
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("text", ["constant", "poly:0", "poly:0.5", "poly:1.7", "exp:0.3", "exp:0.7"])
def test_staleness_weights_are_jax_bit_for_bit(text):
    j, t = jdl.parse_staleness(text), tdl.parse_staleness(text)
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert (t.is_trivial, t.describe()) == (j.is_trivial, j.describe())
    s = np.concatenate([np.arange(7), np.random.default_rng(0).random(9) * 5])
    np.testing.assert_array_equal(t.weights(s), j.weights(s))
    assert (t.weights(np.zeros(3)) == 1.0).all()


@pytest.mark.parametrize("bad", ["poly", "poly:x", "exp:", "poly:-1", "linear:2", "constant:3"])
def test_staleness_parse_errors_use_jax_words(bad):
    with pytest.raises(ValueError) as je:
        jdl.parse_staleness(bad)
    with pytest.raises(ValueError) as te:
        tdl.parse_staleness(bad)
    assert str(te.value) == str(je.value)


@pytest.mark.parametrize("speed,jitter,seed", [
    ("det", "det", 0), ("lognormal:0.5", "lognormal:0.2", 7), ("mixture:0.5@1,0.5@3", "lognormal:0.1", 2),
])
def test_cadences_match_jax_and_resume(speed, jitter, seed):
    j = jdl.EdgeCadenceModel(4, 2.0, speed=speed, jitter=jitter, seed=seed)
    t = tdl.EdgeCadenceModel(4, 2.0, speed=speed, jitter=jitter, seed=seed)
    np.testing.assert_array_equal(t.slowness, j.slowness)
    snap = t.state_dict()
    ahead = [t.interval_durations() for _ in range(3)]
    for d in ahead:
        np.testing.assert_array_equal(d, j.interval_durations())
    t.load_state_dict(snap)
    for d in ahead:
        np.testing.assert_array_equal(t.interval_durations(), d)


def test_cadence_from_stragglers_reads_slowness_not_the_stream():
    jm = jfail.StragglerModel(6, mean_step_s=2.0, sigma=0.6, seed=3)
    tm = tfail.StragglerModel(6, mean_step_s=2.0, sigma=0.6, seed=3)
    seg = np.array([0, 0, 0, 1, 1, 1])
    j = jdl.EdgeCadenceModel.from_stragglers(jm, seg, 3, kappa1=4, jitter="lognormal:0.1", seed=1)
    t = tdl.EdgeCadenceModel.from_stragglers(tm, seg, 3, kappa1=4, jitter="lognormal:0.1", seed=1)
    np.testing.assert_array_equal(t.slowness, j.slowness)
    assert t.slowness[2] == 1.0 and t.base_interval_s == j.base_interval_s == 8.0
    np.testing.assert_array_equal(t.interval_durations(), j.interval_durations())
    # the straggler models' streams were not touched: their masks still agree
    np.testing.assert_array_equal(tm.survivors(4, None)[0], jm.survivors(4, None)[0])


SCHEDULERS = {
    "barrier": dict(cad=dict(), kw=dict()),
    "quorum": dict(cad=dict(speed="lognormal:0.6", seed=3), kw=dict(quorum=0.5, staleness="poly:1", max_staleness=5)),
    "buffer": dict(cad=dict(speed="lognormal:0.5", seed=7), kw=dict(buffer_size=2, staleness="poly:0.5",
                                                                     max_staleness=3)),
    "timeout": dict(cad=dict(speed="lognormal:0.8", jitter="lognormal:0.3", seed=1),
                    kw=dict(timeout_s=2.5, staleness="exp:0.4", max_staleness=10)),
    "max_staleness": dict(cad=dict(slowness=[1.0, 1.0, 1.0, 10.0, 1.0]), kw=dict(quorum=0.5, max_staleness=2)),
    "dropout_retry": dict(cad=dict(speed="lognormal:0.3", seed=4),
                          kw=dict(quorum=0.8, edge_drop_rate=0.4, retry_limit=1, staleness="exp:0.7", seed=12)),
    "dead_edges": dict(cad=dict(speed="lognormal:0.4", seed=9), kw=dict(quorum=0.6, max_staleness=3, seed=5),
                       dead=0.3),
    "total_outage": dict(cad=dict(), kw=dict(quorum=0.6), dead=1.0),
}


def _schedulers(case):
    c = SCHEDULERS[case]
    cad = dict(c["cad"])
    if "slowness" in cad:
        cad["slowness"] = np.asarray(cad["slowness"])
    return (jdl.SemiSyncScheduler(jdl.EdgeCadenceModel(5, 1.5, **cad), intervals_per_round=3, **c["kw"]),
            tdl.SemiSyncScheduler(tdl.EdgeCadenceModel(5, 1.5, **cad), intervals_per_round=3, **c["kw"]))


@pytest.mark.parametrize("case", sorted(SCHEDULERS))
def test_scheduler_plans_are_jax_bit_for_bit(case):
    j, t = _schedulers(case)
    assert t.is_barrier == j.is_barrier
    p_dead = SCHEDULERS[case].get("dead", 0.0)
    rng = np.random.default_rng(2)
    segments = np.repeat(np.arange(5), [3, 1, 4, 2, 2])
    kinds = set()
    for _ in range(14):
        dead = (rng.random(5) < p_dead) if p_dead else None
        jp, tp = j.next_round(dead=dead), t.next_round(dead=dead)
        _plans_equal(tp, jp)
        np.testing.assert_array_equal(tp.client_gate(segments), jp.client_gate(segments))
        assert tp.client_gate(segments).dtype == np.float32
        kinds.add("trivial" if tp.is_trivial else "gated")
        if tp.dropped.any():
            kinds.add("dropped")
        if tp.dead.all():
            assert tp.close == tp.start and not tp.folded.any()
            kinds.add("outage")
    want = {"barrier": {"trivial"}, "total_outage": {"outage", "gated"}}.get(case, None)
    if want is not None:
        assert kinds == want
    else:
        assert "gated" in kinds
    if case == "dropout_retry":
        assert "dropped" in kinds
    if case == "max_staleness":
        assert int(t.staleness.max()) <= 2
    assert t.clock == j.clock and t.rounds_closed == j.rounds_closed == 14


def test_scheduler_state_round_trips_through_json_into_either_package():
    j, t = _schedulers("dropout_retry")
    for _ in range(3):
        j.next_round(), t.next_round()
    wire = json.loads(json.dumps(tmanager._jsonable(t.state_dict())))
    ahead = [t.next_round() for _ in range(5)]
    j2, t2 = _schedulers("dropout_retry")
    t2.next_round()  # another position: the load must overwrite it all
    j2.load_state_dict(jmanager._unjsonable(wire))
    t2.load_state_dict(tmanager._unjsonable(wire))
    for p in ahead:
        _plans_equal(t2.next_round(), p)
        _plans_equal(j2.next_round(), p)


def test_scheduler_validation_uses_jax_words():
    for kw in ({"quorum": 0.0}, {"quorum": 1.5}, {"timeout_s": -1.0}, {"buffer_size": 6}, {"max_staleness": -1},
               {"edge_drop_rate": 1.0}, {"retry_limit": -1}, {"intervals_per_round": 0}):
        with pytest.raises(ValueError) as je:
            jdl.SemiSyncScheduler(jdl.EdgeCadenceModel(5, 1.0), **kw)
        with pytest.raises(ValueError) as te:
            tdl.SemiSyncScheduler(tdl.EdgeCadenceModel(5, 1.0), **kw)
        assert str(te.value) == str(je.value)
    for args, kw in (((0,), {}), ((2, 0.0), {}), ((2,), {"slowness": np.ones(3)})):
        with pytest.raises(ValueError) as je:
            jdl.EdgeCadenceModel(*args, **kw)
        with pytest.raises(ValueError) as te:
            tdl.EdgeCadenceModel(*args, **kw)
        assert str(te.value) == str(je.value)


# ---------------------------------------------------------------------------
# The gated superround on one interval
# ---------------------------------------------------------------------------

DIM, HIDDEN, CLASSES, BATCH = 6, 8, 4, 3
MODEL = [f"data.dim={DIM}", f"model.hidden={HIDDEN}", f"data.num_classes={CLASSES}"]


def _unit_gate(spec, unit_weights):
    seg = np.asarray(spec.segments(spec.depth - 1)) if spec.depth >= 2 else np.zeros(spec.num_clients, np.int64)
    return np.asarray(unit_weights, np.float64)[seg].astype(np.float32)


@pytest.mark.parametrize(
    "tree,kappas,units,masked",
    [
        ("5,5,5,5/4", (2, 3), [1.0, 0.0, 0.7071067811865476, 0.3], False),
        ("5,5,5,5/4", (2, 3), [0.5, 1.0, 0.0, 0.0], True),
        ("16,12,10,7,5/5", (2, 3), [1.0, 0.4965853037914095, 0.0, 1.0, 0.25], True),
        ("10,10,10,10,10/3,2/2", (1, 2, 2), [0.0, 0.57735], False),
        ("10,10,10,10,10/3,2/2", (1, 2, 2), [1.0, 0.3], True),
        ("5,5,5,5/4", (2, 2), [0.0, 0.0, 0.0, 0.0], False),
        ("16,12,10,7,5/5", (1, 2), [0.0] * 5, True),
    ],
    ids=["uniform", "uniform_masked", "ragged_masked", "three_level", "three_level_masked", "all_zero_gate",
         "ragged_all_zero_gate_masked"],
)
def test_gated_superround_matches_jax(tree, kappas, units, masked):
    jspec_model = japi.ExperimentSpec.parse(MODEL)
    tspec_model = tapi.ExperimentSpec.parse(MODEL)
    np_params = jax.device_get(jspec_model.init_params(jax.random.PRNGKey(1)))
    jb, tb = japi._model_bundle(jspec_model), tspec_model.model_bundle("cpu")
    jspec, tspec = jparse(tree), tparse(tree)
    jcfg, tcfg = jh.HierFAVGConfig.multi_level(kappas), th.HierFAVGConfig.multi_level(kappas)
    jopt = joptim.sgd(joptim.exponential_decay(0.15, 0.9, 3))
    topt = toptim.sgd(toptim.exponential_decay(0.15, 0.9, 3))
    js = jh.init_state(jax.random.PRNGKey(0), jax.tree_util.tree_map(jnp.asarray, np_params), jopt, jspec, jcfg)
    ts = th.init_state(torch.Generator().manual_seed(0), tspec_model.params_from_numpy(np_params, "cpu"), topt,
                       tspec, tcfg)
    rng = np.random.default_rng(len(tree) + sum(kappas))
    n = jspec.num_clients
    weights = rng.integers(20, 80, n).astype(np.float32)
    k2 = jcfg.kappa2_effective
    block = {"inputs": rng.normal(size=(k2, jcfg.kappa1, n, BATCH, DIM)).astype(np.float32),
             "targets": rng.integers(0, CLASSES, size=(k2, jcfg.kappa1, n, BATCH)).astype(np.int32)}
    masks = (rng.random((k2, n)) > 0.25).astype(np.float32) if masked else None
    gate = _unit_gate(jspec, units)
    jround = jax.jit(jh.build_deadline_super_round(jb["loss"], jopt, jspec, jcfg, jnp.asarray(weights)))
    tround = th.build_deadline_super_round(tb["loss"], topt, tspec, tcfg, torch.from_numpy(weights))
    js, jm = jround(js, {k: jnp.asarray(v) for k, v in block.items()}, jnp.asarray(gate),
                    None if masks is None else jnp.asarray(masks))
    ts, tm = tround(ts, {k: torch.from_numpy(v) for k, v in block.items()}, torch.from_numpy(gate),
                    None if masks is None else torch.from_numpy(masks))
    assert_close(to_numpy(tm), jax.device_get(jm), what=f"metrics {tree}", **TOL)
    assert_close(to_numpy(ts.params), jax.device_get(js.params), what=f"params {tree} {units}", **TOL)
    assert int(ts.step) == int(js.step) == jcfg.cloud_interval
    if not any(units):
        # an all-zero gate folds nothing: the dead-group rule keeps the top
        # stage's rows and the select keeps the edge-synced model, so each
        # edge's rows are one model and the edges still differ
        seg = np.asarray(tspec.segments(1))
        for k, v in ts.params.items():
            rows = v.reshape(n, -1)
            firsts = [rows[np.flatnonzero(seg == e)[0]] for e in range(tspec.num_nodes(1))]
            assert all(torch.equal(rows[i], firsts[seg[i]]) for i in range(n)), k
            assert not all(torch.equal(f, firsts[0]) for f in firsts), k


def test_an_all_one_gate_is_the_superround_in_the_port():
    """The gated function with every unit folded at weight 1 computes the
    synchronous interval (the engine still dispatches the stock superround
    for such plans)."""
    tspec_model = tapi.ExperimentSpec.parse(MODEL)
    tb = tspec_model.model_bundle("cpu")
    spec = tparse("16,12,10,7,5/5")
    cfg = th.HierFAVGConfig.multi_level((2, 3))
    rng = np.random.default_rng(5)
    w = torch.from_numpy(rng.integers(20, 80, 50).astype(np.float32))
    block = {"inputs": torch.from_numpy(rng.normal(size=(3, 2, 50, BATCH, DIM)).astype(np.float32)),
             "targets": torch.from_numpy(rng.integers(0, CLASSES, size=(3, 2, 50, BATCH)).astype(np.int32))}
    masks = torch.from_numpy((rng.random((3, 50)) > 0.2).astype(np.float32))
    params = tspec_model.init_params(1, "cpu")
    states = [th.init_state(torch.Generator().manual_seed(0), params, toptim.sgd(0.1), spec, cfg) for _ in range(2)]
    a, ma = th.build_super_round(tb["loss"], toptim.sgd(0.1), spec, cfg, w)(states[0], block, masks)
    b, mb = th.build_deadline_super_round(tb["loss"], toptim.sgd(0.1), spec, cfg, w)(
        states[1], block, torch.ones(50), masks)
    assert all(torch.equal(ma[k], mb[k]) for k in ma)
    assert all(torch.equal(a.params[k], b.params[k]) for k in a.params)


# ---------------------------------------------------------------------------
# Runs: the barrier contract, the scenarios against JAX, resume
# ---------------------------------------------------------------------------


def _small(*overrides):
    return ["topology.num_edges=3", "topology.clients_per_edge=4", "schedule.kappas=2,4", "data.num_samples=400",
            "run.num_rounds=8", "run.eval_every=4", *overrides]


def _rows(runner, skip=()):
    return [tuple(getattr(h, f.name) for f in dataclasses.fields(h) if f.name not in skip) for h in runner.history]


def _run_port(overrides, params=None, resume=False):
    spec = tapi.ExperimentSpec.parse(overrides)
    if params is None:
        params = spec.init_params(1, "cpu")
    return spec.run_experiment(device="cpu", params={k: v.clone() for k, v in params.items()}, resume=resume)


@pytest.mark.parametrize("extra", [[], ["failures.straggler_sigma=0.3", "failures.straggler_mean_s=1.0"]],
                         ids=["uniform", "stragglers"])
def test_barrier_is_the_synchronous_engine_bit_for_bit(extra):
    params = tapi.ExperimentSpec.parse(_small()).init_params(1, "cpu")
    r_sync, s_sync = _run_port(_small(*extra), params)
    r_dl, s_dl = _run_port(_small(*extra, "deadline.enabled=true", "deadline.quorum=1.0"), params)
    assert type(r_sync._engine) is SuperRoundEngine and type(r_dl._engine) is DeadlineEngine
    assert r_dl._engine.gated_intervals == 0
    for k in s_sync.params:
        assert torch.equal(s_sync.params[k], s_dl.params[k]), k
    assert int(s_sync.opt_state.count) == int(s_dl.opt_state.count)
    assert _rows(r_sync, ("wall_clock_s",)) == _rows(r_dl, ("wall_clock_s",))
    assert all(h.wall_clock_s == 0.0 for h in r_sync.history)
    walls = [h.wall_clock_s for h in r_dl.history]
    assert walls[0] > 0 and all(b > a for a, b in zip(walls, walls[1:]))
    if extra:
        assert r_dl.deadline.cadence.base_interval_s == pytest.approx(2.0)
        assert r_dl.deadline.cadence.slowness.max() > 1.0


def _run_both(jspec, tspec):
    np_params = jax.device_get(jspec.init_params(jax.random.PRNGKey(jspec.run.seed + 1)))
    jr, js = jspec.run_experiment()
    tr, ts = tspec.run_experiment(device="cpu", params=tspec.params_from_numpy(np_params, "cpu"))
    assert len(tr.history) == len(jr.history) == jspec.run.num_rounds
    for a, b in zip(jr.history, tr.history):
        assert (b.round, b.step, b.mask_alive) == (a.round, a.step, a.mask_alive)
        assert b.loss == pytest.approx(a.loss, rel=1e-4), f"round {a.round} loss"
        assert b.grad_norm == pytest.approx(a.grad_norm, rel=1e-4), f"round {a.round} grad_norm"
        assert b.wall_clock_s == a.wall_clock_s, f"round {a.round} wall clock"
        assert (a.accuracy is None) == (b.accuracy is None)
        if a.accuracy is not None:
            assert abs(b.accuracy - a.accuracy) <= 0.01
    assert_close(to_numpy(ts.params), jax.device_get(js.params), rtol=0.0, atol=1e-4, what="final params")
    return jr, tr


@pytest.mark.parametrize("name,overrides", [
    *[(n, RUN_20) for n in DEADLINE_SCENARIOS],
    ("ragged_edges", RUN_20 + ["deadline.enabled=true", "deadline.quorum=0.6", "deadline.edge_speed=lognormal:0.5"]),
    ("three_level", RUN_20 + ["data.num_samples=1000", "deadline.enabled=true", "deadline.quorum=0.5",
                              "deadline.edge_speed=lognormal:0.5", "deadline.staleness=exp:0.7"]),
    ("quickstart", ["run.num_rounds=16", "failures.p_fail=0.3", "deadline.enabled=true", "deadline.quorum=0.67",
                    "deadline.edge_speed=lognormal:0.6", "deadline.staleness=poly:0.5", "deadline.seed=2"]),
])
def test_deadline_runs_track_jax(name, overrides):
    """The registered deadline scenarios (20 rounds, eval every cloud
    interval), the ragged tree (K2 under the gate), three levels (regions
    are the gated units) and dead edges from client failures (the outage
    channel of the mask composition)."""
    jr, tr = _run_both(jscen.get(name, overrides=overrides), tscen.get(name, overrides=overrides))
    assert type(tr._engine) is DeadlineEngine
    assert tr._engine.gated_intervals >= 1
    walls = [h.wall_clock_s for h in tr.history]
    assert all(b > a for a, b in zip(walls, walls[1:]))
    if name == "deadline_straggler":
        assert tr.history[-1].wall_clock_s == pytest.approx(138.58, abs=0.01)


def test_deadline_resume_is_bit_equal_to_the_straight_run(tmp_path):
    def ov(d):
        return _small("deadline.enabled=true", "deadline.quorum=0.67", "deadline.edge_speed=lognormal:0.6",
                      "deadline.staleness=poly:1", "deadline.edge_drop_rate=0.2", "deadline.seed=3",
                      "run.checkpoint_every=4", f"run.checkpoint_dir={d}")

    params = tapi.ExperimentSpec.parse(_small()).init_params(1, "cpu")
    straight, s_straight = _run_port(ov(tmp_path / "a"), params)
    assert straight._engine.gated_intervals >= 1
    _run_port(ov(tmp_path / "b") + ["run.num_rounds=4"], params)
    resumed, s_resumed = _run_port(ov(tmp_path / "b"), params, resume=True)
    assert [h.round for h in resumed.history] == [4, 5, 6, 7]
    assert _rows(resumed) == _rows(straight)[4:]  # the wall clock included
    for k in s_straight.params:
        assert torch.equal(s_straight.params[k], s_resumed.params[k]), k
    assert resumed.deadline.clock == straight.deadline.clock
    np.testing.assert_array_equal(resumed.deadline.staleness, straight.deadline.staleness)


# ---------------------------------------------------------------------------
# Refusals, the async_cloud mapping, the spec
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("overrides", [
    ["transport.levels=identity/int8:128"],
    ["schedule.delta_cloud=true"],
    ["schedule.sync_opt_state=true"],
    ["aggregators.levels=weighted_mean/coordinate_median"],
    ["aggregators.levels=trimmed_mean:0.1/weighted_mean"],
    ["participation.cohort_size=6"],
    [],
])
def test_deadline_incompatibility_uses_jax_words(overrides):
    jspec, tspec = japi.ExperimentSpec.parse(_small(*overrides)), tapi.ExperimentSpec.parse(_small(*overrides))
    want = jh.deadline_incompatibility(jspec.hier_config(), jspec.topology.build())
    assert th.deadline_incompatibility(tspec.hier_config(), tspec.topology.build()) == want
    if want is not None and "participation" not in overrides[0]:
        with pytest.raises(ValueError, match="the deadline engine cannot run: " + want[:30]):
            tapi.ExperimentSpec.parse(_small(*overrides, "deadline.enabled=true")).run_experiment(device="cpu")


@pytest.mark.parametrize("overrides,start", [
    (["run.eval_every=3"], 0), (["run.checkpoint_every=2", "run.checkpoint_dir=unused"], 0),
    (["run.engine=per_round"], 0), (["run.engine=megakernel"], 0), (["run.num_rounds=6"], 0), ([], 2),
    (["participation.cohort_size=6"], 0), ([], 0),
])
def test_deadline_reasons_use_jax_words(overrides, start):
    ov = _small("deadline.enabled=true", *overrides)
    jrunner, trunner = japi.ExperimentSpec.parse(ov).build(), tapi.ExperimentSpec.parse(ov).build(device="cpu")
    assert trunner._deadline_reason(start) == jrunner._deadline_reason(start)


def test_the_registered_scenarios_refuse_eval_every_1_in_jax_words():
    for name in DEADLINE_SCENARIOS:
        with pytest.raises(ValueError) as je:
            jscen.get(name, overrides=["run.num_rounds=20"]).run_experiment()
        with pytest.raises(ValueError) as te:
            tscen.get(name, overrides=["run.num_rounds=20"]).run_experiment(device="cpu")
        assert str(te.value) == str(je.value) == (
            "the deadline engine cannot run: eval_every=1 is finer than a cloud interval (kappa2_eff=10)")


def test_async_cloud_maps_to_the_deadline_engine_with_jax_warning():
    ov = _small("schedule.async_cloud=true")
    with pytest.warns(DeprecationWarning) as jw:
        jrunner = japi.ExperimentSpec.parse(ov).build()
    with pytest.warns(DeprecationWarning) as tw:
        trunner = tapi.ExperimentSpec.parse(ov).build(device="cpu")
    assert [str(w.message) for w in tw] == [str(w.message) for w in jw]
    assert trunner.deadline.quorum == jrunner.deadline.quorum == 0.5
    assert trunner.deadline.policy.describe() == "poly:1"
    with pytest.warns(DeprecationWarning):
        runner, _ = tapi.ExperimentSpec.parse(ov).run_experiment(device="cpu")
    assert type(runner._engine) is DeadlineEngine
    # an explicit deadline section wins, silently
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        trunner2 = tapi.ExperimentSpec.parse(_small("schedule.async_cloud=true", "deadline.enabled=true")).build(
            device="cpu")
    assert trunner2.deadline.quorum == 1.0


@pytest.mark.parametrize("overrides", [
    ["deadline.enabled=true", "deadline.buffer_size=2", "deadline.staleness=exp:0.7", "deadline.timeout_s=5.5"],
    ["deadline.enabled=true", "deadline.mean_interval_s=3.5", "deadline.edge_jitter=lognormal:0.2"],
    ["deadline.enabled=true", "cost.workload=none"],
    ["deadline.enabled=true", "cost.workload=cifar10", "deadline.edge_speed=mixture:0.5@1,0.5@4"],
])
def test_deadline_spec_builds_the_jax_scheduler(overrides):
    ov = _small(*overrides)
    jspec, tspec = japi.ExperimentSpec.parse(ov), tapi.ExperimentSpec.parse(ov)
    assert tspec.to_json() == jspec.to_json() and tspec.describe() == jspec.describe()
    assert tapi.ExperimentSpec.from_json(tspec.to_json()) == tspec
    j, t = jspec.build().deadline, tspec.build(device="cpu").deadline
    assert t.cadence.base_interval_s == j.cadence.base_interval_s
    for _ in range(4):
        _plans_equal(t.next_round(), j.next_round())
