"""The port's round-replay simulator, cost model extensions and traffic
model against the JAX package's (``repro.sim``, ``repro.core.cost_model``,
``repro.dist.collectives``).

Everything here is host numpy in both packages, drawn from the same seeded
generators in the same order, so the tests hold the port to JAX with
``assert_array_equal`` (bit for bit) wherever JAX's own tests
(``tests/test_sim.py``) call the result deterministic or bit-identical:
draws, generator states, DAGs, calibrated costs, jitter tables, replays,
the shared straggler stream and the association optimizer's search.
"""
import dataclasses
import json
import types

import numpy as np
import pytest

from repro import sim as jsim
from repro.checkpoint import manager as jmanager
from repro.core import cost_model as jcm
from repro.core.hierarchy import HierarchySpec as JSpec
from repro.dist import collectives as jcoll
from repro.fed import failures as jfail
from repro.fed import scenarios as jscen
from repro_torch import sim as tsim
from repro_torch.checkpoint import manager as tmanager
from repro_torch.core import cost_model as tcm
from repro_torch.core.hierarchy import HierarchySpec as TSpec
from repro_torch.dist import collectives as tcoll
from repro_torch.fed import failures as tfail
from repro_torch.fed import scenarios as tscen

TREES = {
    "uniform": [[10] * 5, [5]],
    "ragged": [[16, 12, 10, 7, 5], [5]],
    "depth3": [[2, 3, 2, 1], [2, 2], [2]],
}
DISTS = ["det", "det:2.5", "lognormal:0.3", "lognormal:0.4:2", "mixture:0.9@1,0.1@8", "mixture:0.6@1,0.4@4"]


def _trees(name):
    return JSpec.from_fanouts(TREES[name]), TSpec.from_fanouts(TREES[name])


def _eq(a, b, what=""):
    """Every field of two results (dataclasses, tuples, dicts, arrays) equal,
    arrays bit for bit."""
    if dataclasses.is_dataclass(a) and not isinstance(a, type):
        assert type(a).__name__ == type(b).__name__, what
        for f in dataclasses.fields(a):
            if f.name == "spec":
                assert getattr(a, f.name).parents == getattr(b, f.name).parents, what
            elif f.name not in ("compute_jitter", "link_jitter", "backhaul_jitter"):
                _eq(getattr(a, f.name), getattr(b, f.name), f"{what}.{f.name}")
    elif isinstance(a, dict):
        assert sorted(a) == sorted(b), what
        for k in a:
            _eq(a[k], b[k], f"{what}[{k}]")
    elif isinstance(a, (tuple, list)) and not (a and isinstance(a[0], (int, float)) and not isinstance(a[0], bool)):
        assert len(a) == len(b), what
        for i, (x, y) in enumerate(zip(a, b)):
            _eq(x, y, f"{what}[{i}]")
    else:
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b), err_msg=what)


# ---------------------------------------------------------------------------
# Distributions and the network model
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("text", DISTS)
@pytest.mark.parametrize("seed", [0, 7, (3, 5)])
def test_draws_means_and_generator_state_match_jax(text, seed):
    j, t = jsim.parse_distribution(text, seed=seed), tsim.parse_distribution(text, seed=seed)
    assert type(t).__name__ == type(j).__name__ and t.is_deterministic == j.is_deterministic
    assert t.mean() == j.mean()
    for n in (1, 5, 33):
        np.testing.assert_array_equal(t.sample(n), j.sample(n))
    # a state saved by the port loads in JAX's distribution (through the
    # checkpoint manager's JSON form) and both go on drawing the same numbers
    wire = json.loads(json.dumps(tmanager._jsonable(t.state_dict())))
    ahead = t.sample(9)
    j2 = jsim.parse_distribution(text, seed=123)
    j2.load_state_dict(jmanager._unjsonable(wire))
    np.testing.assert_array_equal(j2.sample(9), ahead)


@pytest.mark.parametrize("bad", ["nope", "det:-1", "lognormal", "lognormal:0", "lognormal:1:2:3",
                                 "mixture:0.5@1", "mixture:1", "mixture:0.5@1,0.5@-2", "poly:2"])
def test_bad_distributions_raise_jax_words(bad):
    with pytest.raises(ValueError) as je:
        jsim.parse_distribution(bad)
    with pytest.raises(ValueError) as te:
        tsim.parse_distribution(bad)
    assert str(te.value) == str(je.value)


def test_wrong_state_kind_is_refused():
    with pytest.raises(ValueError, match="not 'mixture'"):
        tsim.parse_distribution("mixture:1@2").load_state_dict({"kind": "lognormal"})


@pytest.mark.parametrize("tree", sorted(TREES))
@pytest.mark.parametrize("scenario", ["congested_backhaul", "hetero_clients_assoc", "straggler_tail"])
def test_network_model_builds_and_resumes_like_jax(tree, scenario):
    jt, tt = _trees(tree)
    jspec, tspec = jscen.get(scenario).network, tscen.get(scenario).network
    assert dataclasses.asdict(tspec) == dataclasses.asdict(jspec)
    assert (tspec.is_active, tspec.describe()) == (jspec.is_active, jspec.describe())
    jnet, tnet = jspec.build(jt), tspec.build(tt)
    for f in ("client_speed", "client_link", "edge_uplink", "edge_backhaul"):
        np.testing.assert_array_equal(getattr(tnet, f), getattr(jnet, f), err_msg=f)
    assert (tnet.contention, tnet.jitter_granularity) == (jnet.contention, jnet.jitter_granularity)
    snap = tnet.state_dict()
    jt_tab = jsim.draw_jitter_tables(jnet, jt, (2, 3), trials=2)
    tt_tab = tsim.draw_jitter_tables(tnet, tt, (2, 3), trials=2)
    _eq(tt_tab, jt_tab, "tables")
    tnet.load_state_dict(snap)
    _eq(tsim.draw_jitter_tables(tnet, tt, (2, 3), trials=2), jt_tab, "tables after load_state_dict")


# ---------------------------------------------------------------------------
# The round DAG
# ---------------------------------------------------------------------------


@pytest.mark.parametrize(
    "tree,kappas,cohort,masked",
    [
        ("uniform", (6, 10), None, False),
        ("ragged", (2, 3), None, True),
        ("depth3", (2, 2, 2), None, False),
        ("uniform", (3, 2), [0, 1, 2, 10, 11, 47], True),
        ("depth3", (1, 3, 1), [0, 4, 5, 7], False),
    ],
)
def test_round_dag_matches_jax(tree, kappas, cohort, masked):
    jt, tt = _trees(tree)
    c = None if cohort is None else np.asarray(cohort, np.int64)
    n = c.size if c is not None else jt.num_clients
    masks = None
    if masked:
        r = int(np.prod(kappas[1:]))
        masks = np.random.default_rng(3).random((r, n)) > 0.3
    jd = jsim.build_round_dag(jt, kappas, cohort=c, masks=masks)
    td = tsim.build_round_dag(tt, kappas, cohort=c, masks=masks)
    _eq(td, jd, "dag")
    assert td.counts() == jd.counts() and td.sink == jd.sink and td.num_intervals == jd.num_intervals


@pytest.mark.parametrize(
    "kappas,kwargs",
    [((6, 10, 2), {}), ((0, 10), {}), ((2, 2), {"cohort": np.array([3, 1])}),
     ((2, 2), {"cohort": np.array([0, 50])}), ((2, 2), {"cohort": np.array([], np.int64)}),
     ((2, 2), {"masks": np.ones((3, 50))})],
)
def test_round_dag_refuses_like_jax(kappas, kwargs):
    jt, tt = _trees("uniform")
    with pytest.raises(ValueError) as je:
        jsim.build_round_dag(jt, kappas, **kwargs)
    with pytest.raises(ValueError) as te:
        tsim.build_round_dag(tt, kappas, **kwargs)
    assert str(te.value) == str(je.value)


# ---------------------------------------------------------------------------
# Calibration and the cost model
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("workload", ["mnist", "cifar10"])
@pytest.mark.parametrize("depth,bits", [(1, None), (2, None), (2, (8.0, 32.0)), (2, 4), (3, (8.0, 16.0, 4.0))])
def test_calibration_matches_jax(workload, depth, bits):
    jc, tc = jcm.paper_workload(workload), tcm.paper_workload(workload)
    _eq(tsim.from_workload(tc, depth, bits_per_param=bits), jsim.from_workload(jc, depth, bits_per_param=bits))
    jcl = jcm.ClusterCosts(t_step=1e-3, t_edge_agg=2e-4, t_cloud_agg=3e-3)
    tcl = tcm.ClusterCosts(t_step=1e-3, t_edge_agg=2e-4, t_cloud_agg=3e-3)
    _eq(tsim.from_cluster(tcl, depth, bits_per_param=bits), jsim.from_cluster(jcl, depth, bits_per_param=bits))
    term = lambda s: types.SimpleNamespace(bound_s=s, collective_s=s)
    _eq(tsim.from_roofline(term(1e-3), term(2e-4), None, depth, bits_per_param=bits),
        jsim.from_roofline(term(1e-3), term(2e-4), None, depth, bits_per_param=bits))


def test_calibration_refuses_like_jax():
    for call in (lambda m: m.from_workload(jcm.paper_workload("mnist"), 0),
                 lambda m: m.from_workload(jcm.paper_workload("mnist"), 2, bits_per_param=(8.0,)),
                 lambda m: m.from_cluster(jcm.ClusterCosts(1.0, 1.0, 1.0), 2, bits_per_param=(8.0, -1.0)),
                 lambda m: m.SimCosts(1.0, 0.0, (1.0,), (0.0, 0.0))):
        with pytest.raises(ValueError) as je:
            call(jsim)
        with pytest.raises(ValueError) as te:
            call(tsim)
        assert str(te.value) == str(je.value)


def test_cluster_costs_tune_kappas_and_time_energy_to_accuracy_match_jax():
    jcl = jcm.ClusterCosts(t_step=1e-3, t_edge_agg=2e-4, t_cloud_agg=3e-3)
    tcl = tcm.ClusterCosts(t_step=1e-3, t_edge_agg=2e-4, t_cloud_agg=3e-3)
    assert dataclasses.asdict(tcl.with_bits(8, 4)) == dataclasses.asdict(jcl.with_bits(8, 4))
    for k1, k2 in ((1, 1), (6, 10), (15, 4)):
        assert tcl.interval_time(k1, k2) == jcl.interval_time(k1, k2)
        assert tcl.per_step_overhead(k1, k2) == jcl.per_step_overhead(k1, k2)
    with pytest.raises(ValueError, match="positive"):
        tcl.with_bits(0, 32)
    steps = lambda k1, k2: 400.0 + 3.0 * k1 * k2 if k1 * k2 < 200 else float("inf")
    for objective in ("time", "energy"):
        for jc, tc in ((jcl, tcl), (jcm.paper_workload("mnist"), tcm.paper_workload("mnist"))):
            assert tcm.tune_kappas(tc, steps, [1, 5, 10, 30], [1, 2, 5, 10], objective=objective) == \
                jcm.tune_kappas(jc, steps, [1, 5, 10, 30], [1, 2, 5, 10], objective=objective)
    with pytest.raises(ValueError, match="no feasible"):
        tcm.tune_kappas(tcl, lambda a, b: float("inf"), [1], [1])
    for workload in ("mnist", "cifar10"):
        jc, tc = jcm.paper_workload(workload), tcm.paper_workload(workload)
        for args in ((6, 10, 0), (6, 10, 777), (60, 1, 1200)):
            assert tcm.time_energy_to_accuracy(tc, *args) == jcm.time_energy_to_accuracy(jc, *args)


@pytest.mark.parametrize("args", [(1e6, 10, 5, 6, 10), (4.0 * 307210, 8, 4, 8, 2), (123.0, 1, 1, 1, 1)])
@pytest.mark.parametrize("bits", [(32.0, 32.0), (8.0, 4.0)])
def test_hierfavg_traffic_per_step_matches_jax(args, bits):
    kw = dict(edge_bits_per_param=bits[0], cloud_bits_per_param=bits[1])
    assert tcoll.hierfavg_traffic_per_step(*args, **kw) == jcoll.hierfavg_traffic_per_step(*args, **kw)


# ---------------------------------------------------------------------------
# Replays
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["congested_backhaul", "hetero_clients_assoc", "straggler_tail"])
def test_simulate_spec_on_the_sim_scenarios_is_bit_identical_to_jax(name):
    jr = jsim.simulate_spec(jscen.get(name), trials=4)
    tr = tsim.simulate_spec(tscen.get(name), trials=4)
    _eq(tr.dag, jr.dag, "dag")
    for f in ("durations", "finish", "energy", "round_time", "client_energy"):
        np.testing.assert_array_equal(getattr(tr, f), getattr(jr, f), err_msg=f)
    assert tr.summary() == jr.summary()
    assert tr.trials == 4 and np.all(tr.round_time > 0)


@pytest.mark.parametrize("overrides", [
    ["participation.cohort_size=12", "participation.sampler=stratified"],
    ["transport.levels=int8:128/int8:256"],
    ["topology.fanouts=10,10,10,10,10/3,2/2", "schedule.kappas=6,5,2", "network.link_jitter=lognormal:0.2"],
])
def test_simulate_spec_with_cohorts_transports_and_depth3_matches_jax(overrides):
    jr = jsim.simulate_spec(jscen.get("congested_backhaul", overrides=overrides), trials=2)
    tr = tsim.simulate_spec(tscen.get("congested_backhaul", overrides=overrides), trials=2)
    for f in ("durations", "finish", "energy"):
        np.testing.assert_array_equal(getattr(tr, f), getattr(jr, f), err_msg=f)


def test_simulate_spec_refuses_a_spec_without_costs():
    with pytest.raises(ValueError, match="nothing to calibrate"):
        tsim.simulate_spec(tscen.get("congested_backhaul", overrides=["cost.workload=none"]))


@pytest.mark.parametrize("granularity", ["step", "interval"])
def test_replay_once_and_masked_rounds_match_jax(granularity):
    jt, tt = _trees("ragged")
    kw = dict(client_speed="lognormal:0.4", compute_jitter="lognormal:0.2", link_jitter="lognormal:0.1",
              edge_backhaul="mixture:0.8@1,0.2@5", backhaul_jitter="lognormal:0.3", contention=True,
              jitter_granularity=granularity, seed=4)
    jnet, tnet = jsim.NetworkSpec(**kw).build(jt), tsim.NetworkSpec(**kw).build(tt)
    masks = np.random.default_rng(1).random((3, 50)) > 0.2
    jd = jsim.build_round_dag(jt, (2, 3), masks=masks)
    td = tsim.build_round_dag(tt, (2, 3), masks=masks)
    costs = (jsim.from_workload(jcm.paper_workload("mnist"), 2), tsim.from_workload(tcm.paper_workload("mnist"), 2))
    jres = jsim.simulate_round(jd, costs[0], jnet, trials=3)
    tres = tsim.simulate_round(td, costs[1], tnet, trials=3)
    for f in ("durations", "finish", "energy"):
        np.testing.assert_array_equal(getattr(tres, f), getattr(jres, f), err_msg=f)
    for trial in range(3):
        np.testing.assert_array_equal(tsim.replay_once(td, tres.durations[trial]),
                                      jsim.replay_once(jd, jres.durations[trial]))
        np.testing.assert_array_equal(tsim.replay_once(td, tres.durations[trial]), tres.finish[trial])


# ---------------------------------------------------------------------------
# The straggler model's shared stream
# ---------------------------------------------------------------------------


def test_straggler_network_shares_the_models_exact_stream():
    """The replay's interval compute draws come from the port's
    StragglerModel's own generator: equal to JAX's replay, to JAX's
    ``interval_latency`` draws from a twin model, and the two models' masks
    afterwards still agree draw for draw."""
    jt, tt = JSpec.uniform(2, 8), TSpec.uniform(2, 8)
    k1, k2 = 4, 3
    jm = jfail.StragglerModel(16, mean_step_s=0.5, sigma=0.4, seed=7)
    tm = tfail.StragglerModel(16, mean_step_s=0.5, sigma=0.4, seed=7)
    twin = jfail.StragglerModel(16, mean_step_s=0.5, sigma=0.4, seed=7)
    jnet, tnet = jsim.straggler_network(jm, jt), tsim.straggler_network(tm, tt)
    assert tnet.compute_jitter._rng is tm._rng
    costs = tsim.SimCosts(t_step=0.5, e_step=0.0, link_t=(0.0, 0.0), agg_t=(0.0, 0.0))
    jc = jsim.SimCosts(t_step=0.5, e_step=0.0, link_t=(0.0, 0.0), agg_t=(0.0, 0.0))
    jres = jsim.simulate_round(jsim.build_round_dag(jt, (k1, k2)), jc, jnet, trials=1)
    td = tsim.build_round_dag(tt, (k1, k2))
    tres = tsim.simulate_round(td, costs, tnet, trials=1)
    np.testing.assert_array_equal(tres.durations, jres.durations)
    steps = np.where(td.kind == tsim.STEP)[0]
    got = np.zeros((k2, 16))
    np.add.at(got, (td.interval[steps].astype(int), td.entity[steps].astype(int)), tres.durations[0, steps])
    want = np.stack([twin.interval_latency(k1) for _ in range(k2)])
    np.testing.assert_allclose(got, want, rtol=1e-12)
    np.testing.assert_array_equal(tm.survivors(k1, None)[0], jm.survivors(k1, None)[0])
    with pytest.raises(ValueError, match="clients"):
        tsim.straggler_network(tfail.StragglerModel(8, seed=0), tt)


@pytest.mark.parametrize("cohort", [None, [0, 5, 9, 31]])
@pytest.mark.parametrize("deadline", [None, 5.0])
def test_straggler_masks_match_jax(cohort, deadline):
    jm = jfail.StragglerModel(50, mean_step_s=1.0, sigma=0.6, seed=1)
    tm = tfail.StragglerModel(50, mean_step_s=1.0, sigma=0.6, seed=1)
    c = None if cohort is None else np.asarray(cohort)
    got = tsim.straggler_masks(tm, 4, 3, deadline=deadline, cohort=c)
    np.testing.assert_array_equal(got, jsim.straggler_masks(jm, 4, 3, deadline=deadline, cohort=c))
    assert got.dtype == bool and got.shape == (3, 50 if c is None else c.size)


# ---------------------------------------------------------------------------
# The association optimizer
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("objective,kw", [
    ("p99_time", dict(client_speed="lognormal:0.5", edge_uplink="mixture:0.5@1,0.5@5",
                      link_jitter="lognormal:0.1", contention=True, seed=1)),
    ("energy", dict(client_speed="lognormal:0.3", seed=2)),
])
def test_association_search_matches_jax(objective, kw):
    jt, tt = JSpec.uniform(4, 6), TSpec.uniform(4, 6)
    jnet, tnet = jsim.NetworkSpec(**kw).build(jt), tsim.NetworkSpec(**kw).build(tt)
    jc = jsim.from_workload(jcm.paper_workload("mnist"), 2)
    tc = tsim.from_workload(tcm.paper_workload("mnist"), 2)
    jr = jsim.optimize_association(jt, jc, jnet, (6, 2), objective=objective, trials=8, top_k=3, max_rounds=3)
    tr = tsim.optimize_association(tt, tc, tnet, (6, 2), objective=objective, trials=8, top_k=3, max_rounds=3)
    _eq(tr, jr, "association")
    assert tr.to_dict() == jr.to_dict() and tr.improvement == jr.improvement
    spec, order = tsim.assignment_to_spec(tr.assignment, tt)
    assert spec.parents == tr.spec.parents
    np.testing.assert_array_equal(order, tr.client_order)


def test_association_refuses_like_jax():
    jt, tt = JSpec.uniform(2, 3), TSpec.uniform(2, 3)
    jnet = jsim.NetworkSpec(client_speed="lognormal:0.3", seed=2).build(jt)
    tnet = tsim.NetworkSpec(client_speed="lognormal:0.3", seed=2).build(tt)
    jc = jsim.from_workload(jcm.paper_workload("mnist"), 2)
    tc = tsim.from_workload(tcm.paper_workload("mnist"), 2)
    calls = [
        lambda s, t, c, n: s.optimize_association(t, c, n, (2, 2), objective="latency"),
        lambda s, t, c, n: s.optimize_association(t, c, n, (2, 2), capacity=np.array([2, 2])),
        lambda s, t, c, n: s.assignment_to_spec(np.zeros(6, np.int64), t),
        lambda s, t, c, n: s.assignment_to_spec(np.full(6, 7), t),
    ]
    for call in calls:
        with pytest.raises(ValueError) as je:
            call(jsim, jt, jc, jnet)
        with pytest.raises(ValueError) as te:
            call(tsim, tt, tc, tnet)
        assert str(te.value) == str(je.value)


def test_sim_exports_match_jax():
    assert tsim.__all__ == jsim.__all__
    assert (tsim.STEP, tsim.HOP, tsim.AGG) == (jsim.STEP, jsim.HOP, jsim.AGG)
