"""The paper's figure and table scripts of the port
(``repro_torch.experiments``) against the JAX package on the CPU.

Each training script runs at a cut depth with the JAX init carried across
(``common.run_spec(init=)``), and every run it makes
(``common.recorded_runs``) is held to the same spec trained by the JAX
package's ``run_experiment``: per-round loss and grad norm ``rtol=1e-4``,
accuracy within 0.01, T, E and wire MB to 1e-12 relative (host arithmetic),
the deadline engine's event clock exactly. A script's steps-to-alpha is
compared only where JAX's accuracy at each eval up to the crossing lies
more than 0.01 from alpha: inside that band the two packages may cross one
eval apart. Table I equals ``repro.core.cost_model``; the traffic rows
equal JAX's ``hierarchy_traffic_per_step`` to 1e-12 relative; the replay
sections are ``repro.sim``'s bit for bit.

Every test runs on one intra-op thread: the stand-in's tensors are tiny,
and under the suite's workers more threads only contend.
"""
import json
import os
import sys

import numpy as np
import pytest
import torch

from repro.configs.base import param_count as jparam_count
from repro.configs.registry import get_config as jget_config
from repro.core import cost_model as jcm
from repro.core.hierarchy import HierarchySpec as JHierarchySpec
from repro.core.hierarchy import parse_fanouts as jparse
from repro.dist.collectives import hierarchy_traffic_per_step as jtraffic
from repro.fed import api as japi
from repro.fed import scenarios as jscen
from repro import sim as jsim
from repro_torch.experiments import __main__ as runner_main
from repro_torch.experiments import (
    aggregation_scaling,
    common,
    compression_tradeoff,
    fig2_topologies,
    fig4_convergence,
    round_time_sim,
    table1_cost_model,
    table2_latency_energy,
    wallclock_curves,
)
from repro_torch.fed.engine import DeadlineEngine

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from torch_jax_runs import BAND, clear_crossing, held_to_jax, jax_init, jax_spec  # noqa: E402

@pytest.fixture(autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def run_script(fn, *args, **kw):
    """``fn`` on the CPU from JAX's init; returns (its result, the runs it made)."""
    with common.recorded_runs() as runs:
        out = fn(*args, device="cpu", init=jax_init, **kw)
    return out, runs


# -- the spec ---------------------------------------------------------------------


def jax_bench_spec(kappa1, kappa2, *, partition="edge_iid", rounds=None, seed=0, workload="mnist",
                   eval_every=1, lr=0.15, class_sep=3.5, transport="identity", aggregators="weighted_mean",
                   fanouts="", kappas=None):
    """The JAX reproduction scripts' spec, built field for field."""
    kv = tuple(kappas) if kappas is not None else (kappa1, kappa2)
    if rounds is None:
        rounds = max(240 // kv[0], 6)
    return japi.ExperimentSpec(
        name=f"bench_k{'_'.join(map(str, kv))}_{partition}",
        topology=japi.TopologySpec(fanouts=fanouts) if fanouts else japi.TopologySpec(num_edges=5,
                                                                                       clients_per_edge=10),
        schedule=japi.ScheduleSpec(kappas=kv),
        data=japi.DataSpec(partition=partition, class_sep=class_sep, seed=seed),
        model=japi.ModelSpec(lr=lr, lr_schedule="exponential"),
        transport=japi.TransportSpec(levels=transport),
        aggregators=japi.AggregatorSpec(levels=aggregators),
        cost=japi.CostSpec(workload=workload),
        run=japi.RunSpec(num_rounds=rounds, eval_every=eval_every, seed=seed),
    )


@pytest.mark.parametrize("args,kw", [
    ((60, 1), {}),
    ((6, 10), dict(partition="edge_niid", rounds=36)),
    ((30, 2), dict(workload="cifar10", partition="simple_niid", class_sep=2.0, seed=3)),
    ((15, 4), dict(transport="identity/int8", eval_every=4)),
    ((6, 5), dict(kappas=(6, 5, 2), fanouts="16,12,10,7,5/3,2/2", aggregators="trimmed_mean:0.1/weighted_mean/"
                  "weighted_mean")),
])
def test_bench_spec_is_jax_s_field_for_field(args, kw):
    tspec, jspec = common.bench_spec(*args, **kw), jax_bench_spec(*args, **kw)
    assert tspec.describe() == jspec.describe()
    assert tspec.to_dict() == json.loads(json.dumps(jspec.to_dict()))


def test_fanouts_text_round_trips_like_jax():
    from repro_torch.core.hierarchy import parse_fanouts

    for text in ("10,10,10,10,10/5", "16,12,10,7,5/3,2/2", "8,6,6,4,3,2,2,1/5,3/2"):
        t, j = parse_fanouts(text), jparse(text)
        assert t.fanouts() == j.fanouts() and t.fanouts_text() == j.fanouts_text()
        assert parse_fanouts(t.fanouts_text()) == t


def test_first_reach_timed_and_merge_write_json(tmp_path):
    class H:
        def __init__(self, step, acc):
            self.step, self.accuracy, self.sim_time_s, self.sim_energy_j = step, acc, step * 0.5, step * 0.1

    class R:
        history = [H(10, None), H(20, 0.5), H(30, 0.9), H(40, 0.95)]

    assert common.first_reach(R, 0.9) == (30, 15.0, 3.0)
    assert common.first_reach(R, 0.99) is None
    calls = []
    secs, out = common.timed(lambda x: calls.append(x) or x + 1, 1, iters=3, warmup=2)
    assert out == 2 and len(calls) == 5 and secs >= 0
    path = tmp_path / "out.json"
    path.write_text(json.dumps({"keep": 1, "sweep": [1, 2]}))
    merged = common.merge_write_json(str(path), {"sweep": [], "new": {"a": 1}}, skip_empty=("sweep",))
    assert merged == {"keep": 1, "sweep": [1, 2], "new": {"a": 1}} == json.loads(path.read_text())


# -- Table I, the traffic rows, the replays -----------------------------------------


def test_table1_is_the_jax_cost_model():
    rows = table1_cost_model.main(device="cpu")
    want = [(n, w.t_comp, w.t_comm_edge, w.e_comp, w.e_comm_edge)
            for n, w in ((n, jcm.paper_workload(n)) for n in ("mnist", "cifar10"))]
    assert rows == want


@pytest.mark.parametrize("argv", [[], ["--levels", "3"], ["--fanout", "16,12,10,7,5/3,2/2", "--kappas", "16,2,2"],
                                  ["--fanout", "8,6,6,4,3,2,2,1/8", "--archs", "yi-9b"]])
def test_aggregation_scaling_rows_are_jax_s(argv):
    out = aggregation_scaling.main(argv, device="cpu")
    assert out["rows"]
    for row in out["rows"]:
        per_dev = jparam_count(jget_config(row["arch"])) * 2 / 16
        assert row["per_dev_bytes"] == per_dev
        want = jtraffic(per_dev, jparse(row["fanouts"]), row["kappas"])
        np.testing.assert_allclose(row["per_level_bytes"], want, rtol=1e-12, atol=0)
    uni = JHierarchySpec.uniform(8, 4)
    per_dev = jparam_count(jget_config("granite-3-2b")) * 2 / 16
    want = jtraffic(per_dev, uni, (1, 1))[-1] / jtraffic(per_dev, uni, (16, 4))[-1]
    assert out["cloud_traffic_reduction"] == pytest.approx(want, rel=1e-12)


def test_round_time_sim_parity_is_repro_sim_bit_for_bit():
    from repro_torch.core.cost_model import paper_workload
    from repro_torch.core.hierarchy import HierarchySpec
    from repro_torch import sim as tsim

    worst = 0.0
    for wl in ("mnist", "cifar10"):
        for bits in (None, (32.0, 8.0)):
            jc = jsim.from_workload(jcm.paper_workload(wl), 2, bits_per_param=bits)
            tc = tsim.from_workload(paper_workload(wl), 2, bits_per_param=bits)
            eff = jcm.paper_workload(wl) if bits is None else jcm.paper_workload(wl).with_bits(*bits)
            for k1, k2 in round_time_sim.PARITY_KAPPAS:
                for jt, tt in ((JHierarchySpec.uniform(5, 10), HierarchySpec.uniform(5, 10)),
                               (JHierarchySpec.from_fanouts([[16, 12, 10, 7, 5], [5]]),
                                HierarchySpec.from_fanouts([[16, 12, 10, 7, 5], [5]]))):
                    j = jsim.simulate_round(jsim.build_round_dag(jt, (k1, k2)), jc)
                    t = tsim.simulate_round(tsim.build_round_dag(tt, (k1, k2)), tc)
                    np.testing.assert_array_equal(t.round_time, j.round_time)
                    np.testing.assert_array_equal(t.client_energy, j.client_energy)
                    want_t, want_e = jcm.cloud_interval_time(eff, k1, k2), jcm.cloud_interval_energy(eff, k1, k2)
                    worst = max(worst, abs(float(j.round_time[0]) - want_t) / want_t,
                                float(np.max(np.abs(j.client_energy[0] - want_e)) / want_e))
    cc = jcm.ClusterCosts(t_step=1e-3, t_edge_agg=2e-4, t_cloud_agg=2e-3)
    j = jsim.simulate_round(jsim.build_round_dag(JHierarchySpec.uniform(5, 10), (6, 10)), jsim.from_cluster(cc, 2))
    worst = max(worst, abs(float(j.round_time[0]) - cc.interval_time(6, 10)) / cc.interval_time(6, 10))
    got = round_time_sim.parity_section()
    assert got["max_rel_err"] == worst and got["ok"]


def test_round_time_sim_determinism_and_scenarios_are_repro_sim_s():
    det = round_time_sim.determinism_section(40)
    want = jsim.simulate_spec(jscen.get("congested_backhaul"), trials=40)
    assert det["bit_identical"] and det["p99_s"] == want.percentiles()["p99_s"]
    got = round_time_sim._replay_scenario("congested_backhaul", 40)
    np.testing.assert_array_equal(got.finish, want.finish)
    np.testing.assert_array_equal(got.energy, want.energy)
    rows = round_time_sim.scenarios_section(20)
    for name, row in rows.items():
        j = jsim.simulate_spec(jscen.get(name), trials=20)
        assert row["round_time"] == j.summary()["round_time"] and row["cdf"] == j.cdf(17)


def test_round_time_sim_gates_and_json(tmp_path):
    path = tmp_path / "sim.json"
    path.write_text(json.dumps({"other": 1}))
    sim = round_time_sim.main(smoke=True, trials=16, json_path=str(path), device="cpu")
    assert round_time_sim.check_gates(sim) == []
    written = json.loads(path.read_text())
    assert written["other"] == 1 and written["sim"]["parity"]["ok"]
    bad = {**sim, "association": {**sim["association"], "p99_after_s": sim["association"]["p99_before_s"] + 1}}
    assert "association made p99 worse" in round_time_sim.check_gates(bad)[0]


# -- the training scripts at a cut depth ----------------------------------------------


def test_fig4_one_iid_and_one_niid_schedule_track_jax():
    out, runs = run_script(fig4_convergence.main, schedules=((30, 2),), rounds=2)
    assert len(runs) == 2 and set(out) == {("edge_iid", 30, 2), ("edge_niid", 30, 2)}
    for (dist, _, _), tr in zip(out, runs):
        assert tr.spec.data.partition == dist
        jr = held_to_jax(tr)
        steps, accs = out[(dist, 30, 2)]
        assert steps == [h.step for h in jr.history if h.accuracy is not None]
        np.testing.assert_allclose(accs, [h.accuracy for h in jr.history if h.accuracy is not None], atol=BAND)


def test_fig2_and_edge_only_track_jax():
    rows, runs = run_script(fig2_topologies.main, rounds={"cloud": 1, "hier": 10, "edge_only": 6})
    assert set(rows) == {"cloud", "hier", "edge_only"} and len(runs) == 3
    jrs = [held_to_jax(tr) for tr in runs]
    edge, jedge = runs[2], jrs[2]
    # the edge's 10 clients are the first edge of the 50-client partition
    assert edge.spec.data.partition_topology == "10,10,10,10,10/5" and len(edge.batcher.client_indices) == 10
    for a, b in zip(edge.batcher.client_indices, jedge.batcher.client_indices):
        np.testing.assert_array_equal(a, b)
    for name, tr, jr in zip(("cloud", "hier", "edge_only"), runs, jrs):
        best = max(h.accuracy for h in jr.history if h.accuracy is not None)
        assert abs(rows[name][0] - best) <= BAND
        if clear_crossing(jr, fig2_topologies.ALPHA):
            hit = common.first_reach(jr, fig2_topologies.ALPHA)
            assert rows[name][1] == pytest.approx(hit[1] if hit else float("inf"), rel=1e-12)


def test_table2_int8_cloud_hop_tracks_jax_and_its_sim_rows_are_jax_s():
    rows, runs = run_script(table2_latency_energy.main, sections="c", kappas=((30, 2),), rounds=2)
    (tr,) = runs
    codecs = tr.hier_config.transport
    assert codecs.codec(1).is_identity and not codecs.codec(2).is_identity
    assert len(tr.history) == 2  # one cloud interval: one compressed sync
    jr = held_to_jax(tr)
    if clear_crossing(jr, 0.85):
        hit = common.first_reach(jr, 0.85)
        assert [r[:4] for r in rows] == ([] if hit is None else [("edge_iid_int8_cloud", 30, 2, hit[0])])
        if hit is not None:
            np.testing.assert_allclose(rows[0][4:], hit[1:], rtol=1e-12)
    p50, p99 = table2_latency_energy._sim_rows(30, 2, 60, "edge_iid", trials=20)
    res = jsim.simulate_spec(jscen.get("congested_backhaul", overrides=["schedule.kappas=30,2"]), trials=20)
    assert (p50, p99) == tuple(float(x) for x in np.percentile(60 / 60 * res.round_time, [50.0, 99.0]))


def test_compression_tradeoff_int8_ef_on_both_hops_tracks_jax():
    rows, runs = run_script(compression_tradeoff.main, codecs=(("int8_ef_both", "int8_ef/int8_ef"),),
                            kappas=((30, 2),), rounds=2)
    (tr,) = runs
    jr = held_to_jax(tr)
    if clear_crossing(jr, 0.85):
        hit = common.first_reach(jr, 0.85)
        assert [r["steps"] for r in rows] == ([] if hit is None else [hit[0]])
        if hit is not None:
            wire = next(h.wire_mb for h in jr.history if h.step >= hit[0])
            assert rows[0]["wire_mb"] == pytest.approx(wire, rel=1e-12)


def test_wallclock_deadline_variant_tracks_jax():
    with common.recorded_runs() as runs:
        res = wallclock_curves._run_variant("deadline", 10, device="cpu", init=jax_init)
    (tr,) = runs
    assert type(tr._engine) is DeadlineEngine and tr._engine.gated_intervals >= 1
    jr = held_to_jax(tr)
    assert res["final_wall_s"] == jr.history[-1].wall_clock_s
    assert [p["round"] for p in res["curve"]] == [4, 9]


def test_wallclock_gates():
    def section(t_sync, t_dl, accs):
        return {"variants": {n: {"rounds": 20, "final_accuracy": a, "time_to_target_s": t}
                             for n, a, t in zip(("sync", "deadline", "buffered"), accs, (t_sync, t_dl, 1.0))}}

    assert wallclock_curves.check_gates(section(30.0, 25.0, (0.9, 0.85, 0.88))) == []
    fails = wallclock_curves.check_gates(section(30.0, 31.0, (0.9, 0.7, 0.88)))
    assert len(fails) == 2 and "not below synchronous" in fails[0] and "deadline: final accuracy" in fails[1]
    assert wallclock_curves.check_gates(section(30.0, None, (0.9, 0.9, 0.9))) == [
        "deadline: never reached the shared target accuracy"]


def test_the_runner_names_its_scripts_and_refuses_an_unknown_one(capsys):
    assert list(runner_main.SCRIPTS) == ["table1_cost_model", "fig4_convergence", "table2_latency_energy",
                                         "fig2_topologies", "aggregation_scaling", "compression_tradeoff",
                                         "round_time_sim", "wallclock_curves"]
    with pytest.raises(SystemExit, match="unknown script 'fig3'"):
        runner_main.main(["--only", "fig3"])
    runner_main.main(["--only", "table1_cost_model", "--device", "cpu"])
    assert "table1_mnist,T_comp=0.0240s" in capsys.readouterr().out
