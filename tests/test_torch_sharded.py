"""The client-sharded superround in the port against the JAX package, on the
CPU, over gloo worlds (ROADMAP.md Queue 1 item 12, first half).

- Placement (``ShardPlacement``, ``plan_shard_placement``),
  ``fed/topology.py``, ``checkpoint/reshard.py`` and
  ``sharding_incompatibility``: equal to JAX exactly (arrays, plans, words)
  over uniform, ragged and depth-3 trees (``tests/test_sharded.py:55-138``'s
  cases and more).
- A world of 1 in process (gloo on a ``HashStore``): the sharded
  superround against JAX's ``build_sharded_super_round`` on a 1-device mesh
  and against the port's single-device superround, at JAX's own mesh
  tolerance (params ``rtol=3e-6, atol=2e-7``, loss and grad norm
  ``rtol=1e-5``), with masks and a dead edge, int8_ef, a trimmed edge
  mean, ``sync_opt_state`` and a depth-3 tree; level syncs below the top
  and the local step bit for bit.
- Spawned worlds of 2 and 4 (``dist.launch.spawn``), ragged trees with
  phantom rows among them, against JAX's 2- and 4-shard runs made in a
  subprocess under ``XLA_FLAGS=--xla_force_host_platform_device_count=4``
  (the reference's own recipe, ``tests/test_sharded.py:9``); one all-reduce
  per cloud interval; edge syncs bit for bit against the single-device
  ones.
- The runner end to end through ``topology.mesh_axes=clients:2``: the
  sharded engine against the single-device history; the per-round path
  and ``_mesh_reason`` for a median cloud; a run cut at its checkpoint and
  resumed, bit-equal, in the single-device file layout.
- The refusals: no process group, a mesh larger than the world, NCCL with
  two ranks on one device, the deadline engine.

Each spawned world starts once per module and runs several cases. Its
ranks import only ``repro_torch`` and run one intra-op thread each.
"""
import os
import pickle
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro.checkpoint import reshard as jreshard
from repro.core import hierfavg as jh
from repro.core import hierarchy as jhier
from repro.core.aggregation import AggregatorSpec as JAggregatorSpec
from repro.fed import topology as jtopo
from repro.fed.transport import TransportSpec as JTransportSpec
from repro import optim as joptim
from repro_torch.checkpoint import reshard as treshard
from repro_torch.core import hierfavg as th
from repro_torch.core import hierarchy as thier
from repro_torch.dist import launch, sharding
from repro_torch.fed import topology as ttopo
from repro_torch.fed.api import ExperimentSpec

# the runs the spawned ranks make (``dist.launch.spawn`` hands them this
# process's sys.path, so they import it from here too)
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_sharded_runs as drv  # noqa: E402

STATE_TOL = dict(rtol=3e-6, atol=2e-7)  # tests/test_sharded.py:127-128, :500-501
METRIC_TOL = dict(rtol=1e-5, atol=1e-7)  # tests/test_sharded.py:138, :143
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _masks(n, rounds, dead):
    out = [np.ones(n, np.float32) for _ in range(rounds)]
    for r, cols in dead:
        out[r][cols] = 0.0
    return out


# the JAX tests' cases (tests/test_sharded.py:146-229), by name
CASES = {
    "uniform": dict(fanouts="3,3", kappas=(2, 3)),
    "dead_edge": dict(fanouts="2,2,2,2", kappas=(2, 3),
                      masks=_masks(8, 6, [(1, [3]), (2, [0, 1]), (5, [0])])),
    "int8_ef": dict(fanouts="2,2,2,2", kappas=(2, 2), transport="int8_ef:64/int8_ef:64",
                    masks=_masks(8, 4, [(1, [2])])),
    "trimmed_edge": dict(fanouts="3,3,3,3", kappas=(2, 2), aggregators="trimmed_mean:0.25/weighted_mean",
                         masks=_masks(12, 4, [(0, [5])])),
    "sync_opt_state": dict(fanouts="2,2,2,2", kappas=(2, 2), sync_opt_state=True, opt="momentum"),
    "depth3": dict(fanouts="3,2,3,2/2,2/2", kappas=(2, 2, 2)),
    "ragged": dict(fanouts="3,2,3,2/4", kappas=(2, 2), masks=_masks(10, 4, [(1, [0, 1, 2])])),
    "ragged_wide": dict(fanouts="16,12,10,7,5", kappas=(2, 2)),
}
W1 = ["uniform", "dead_edge", "int8_ef", "trimmed_edge", "sync_opt_state", "depth3"]
W2 = ["ragged_wide", "int8_ef", "depth3", "trimmed_edge"]
W4 = ["ragged", "dead_edge", "sync_opt_state"]
EDGE_SYNC = dict(fanouts="3,3,3,3", kappas=(1, 2), level=1, mask=np.array([1, 0, 1] * 4, np.float32))
# each edge of 4 clients over 2 of the 4 ranks, int8_ef at the edge, one
# edge dead: its mean crosses ranks through one all-reduce
EDGE_SYNC_SPAN = dict(fanouts="4,4", kappas=(1, 2), level=1, span=2, transport="int8_ef:64/identity",
                      mask=np.array([1, 0, 1, 1, 0, 0, 0, 0], np.float32))
EDGE_SYNC_INT8 = dict(fanouts="4,2,1,3", kappas=(1, 2), level=1, transport="int8_ef:64/identity",
                      mask=np.array([1, 1, 1, 1, 0, 0, 1, 1, 0, 1], np.float32))


# ---------------------------------------------------------------------------
# the JAX side (also run in a subprocess with four host devices)
# ---------------------------------------------------------------------------


def _jax_drive(case, num_shards=None):
    """``torch_sharded_runs.drive`` in JAX: the single-device superround, or
    ``build_sharded_super_round`` over a ``num_shards``-device mesh, with the
    engine's placement order and host-side metric reduction."""
    from repro.dist.sharding import batch_block_sharding, client_mesh, fed_state_shardings, mask_stack_sharding

    spec = jhier.parse_fanouts(case["fanouts"])
    n = spec.num_clients
    kw = {}
    if case.get("transport"):
        kw["transport"] = JTransportSpec.parse(case["transport"])
    if case.get("aggregators"):
        kw["aggregators"] = JAggregatorSpec.parse(case["aggregators"])
    cfg = jh.HierFAVGConfig.multi_level(case["kappas"], sync_opt_state=bool(case.get("sync_opt_state")), **kw)
    opt = joptim.momentum(0.1, 0.9) if case.get("opt") == "momentum" else joptim.sgd(0.1)
    centers, sizes = drv.quad_problem(n, case.get("seed", 0))
    w = jnp.asarray(sizes, jnp.float32)
    k1, k2 = cfg.kappa1, cfg.kappa2_effective
    loss_fn = lambda p, b, _r: 0.5 * jnp.sum((p["w"] - b["c"]) ** 2)
    state = jh.init_state(jax.random.PRNGKey(0), {"w": jnp.zeros(drv.DIM)}, opt, spec, cfg)
    block = {"c": jnp.broadcast_to(jnp.asarray(centers), (k2, k1, n, drv.DIM))}
    masks = case.get("masks")
    if num_shards is None:
        fn = jax.jit(jh.build_super_round(loss_fn, opt, spec, cfg, w))
    else:
        mesh = client_mesh(num_shards)
        placement = jhier.plan_shard_placement(spec, num_shards)
        fn = jax.jit(jh.build_sharded_super_round(loss_fn, opt, spec, cfg, w, mesh=mesh, placement=placement))
        gather, valid = jnp.asarray(placement.gather_index()), placement.valid()
        state = jh.map_stacked_fed_state(state, lambda x: jnp.take(x, gather, axis=0), lambda x: x, n)
        state = jax.device_put(state, fed_state_shardings(mesh, "clients", state, placement.padded_clients))
        block = jax.device_put({"c": jnp.take(block["c"], gather, axis=2)}, batch_block_sharding(mesh, "clients"))
    loss, gnorm, steps = [], [], []
    for q in range(case.get("intervals", 2)):
        st = None if masks is None else np.stack(masks[q * k2:(q + 1) * k2]).astype(np.float32)
        if num_shards is None:
            state, m = fn(state, block, None if st is None else jnp.asarray(st))
            m = jax.device_get(m)
            loss.append(np.asarray(m["loss"]))
            gnorm.append(np.asarray(m["grad_norm"]))
        else:
            dm = None if st is None else jax.device_put(
                jnp.asarray(st[:, placement.gather_index()] * valid[None, :]), mask_stack_sharding(mesh, "clients"))
            state, m = fn(state, block, dm)
            m = jax.device_get(m)
            loss.append(np.asarray(m["loss"])[:, :, valid].mean(axis=(1, 2)))
            gnorm.append(np.sqrt(np.asarray(m["gsq"])[:, :, valid].sum(axis=2)).mean(axis=1))
        steps.append([int(s) for s in np.asarray(m["step"])])
    if num_shards is not None:
        pos = jnp.asarray(placement.positions())
        state = jh.map_stacked_fed_state(state, lambda x: jnp.take(x, pos, axis=0), lambda x: x,
                                         placement.padded_clients)
    arr = lambda t: [] if t is None else [np.asarray(x) for x in jax.tree_util.tree_leaves(t)
                                          if getattr(x, "ndim", 0) >= 1]
    return {"params": arr(state.params), "opt": arr(state.opt_state), "anchor": arr(state.anchor),
            "residual": arr(state.residual), "step": int(state.step), "loss": np.stack(loss),
            "grad_norm": np.stack(gnorm), "steps": steps}


def _jax_main(inp: str, out: str) -> None:
    jobs = pickle.load(open(inp, "rb"))
    res = [_jax_drive(case, shards) for case, shards in jobs]
    pickle.dump(res, open(out, "wb"))


# ---------------------------------------------------------------------------
# fixtures: worlds
# ---------------------------------------------------------------------------


@pytest.fixture
def world1():
    """A one-rank gloo world in this process (a ``HashStore`` rendezvous)."""
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0, world_size=1)
    try:
        yield sharding.client_mesh(1, device="cpu")
    finally:
        dist.destroy_process_group()


# the runner end to end (tests/test_sharded.py:337-381's spec)
MESH_SPEC = ["topology.num_edges=4", "topology.clients_per_edge=4", "schedule.kappas=2,3", "run.num_rounds=6",
             "run.eval_every=3", "data.num_samples=320", "failures.p_fail=0.2"]
MEDIAN = MESH_SPEC + ["aggregators.levels=weighted_mean/median"]
CKPT = MESH_SPEC + ["run.checkpoint_every=3", "model.optimizer=adam"]
# runs that take the per-round loop on the mesh, and the reason each names
PER_ROUND = {
    "eval_cadence": (MESH_SPEC + ["run.eval_every=2"], "eval_every=2 is finer than a cloud interval (kappa2_eff=3)"),
    "engine_per_round": (MESH_SPEC + ["run.engine=per_round"], "engine='per_round' runs the per-round loop"),
    "trailing_round": (MESH_SPEC + ["run.num_rounds=7"],
                       "the 1 round(s) after the last whole cloud interval run the per-round loop"),
}


def _spec_jobs(d):
    return [(MESH_SPEC, {}), (MEDIAN, {}),
            (CKPT + [f"run.checkpoint_dir={d}/straight"], {}),
            (CKPT + [f"run.checkpoint_dir={d}/cut", "run.num_rounds=3"], {}),
            (CKPT + [f"run.checkpoint_dir={d}/cut"], {"resume": True})] + [(ov, {}) for ov, _ in PER_ROUND.values()]


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """The spawned worlds of 2 and 4 ranks, and JAX's 2- and 4-shard runs of
    their cases, made meanwhile in a subprocess with four host devices and
    handed over as numpy."""
    d = tmp_path_factory.mktemp("worlds")
    jobs = [(CASES[k], 2) for k in W2] + [(CASES[k], 4) for k in W4]
    pickle.dump(jobs, open(d / "in.pkl", "wb"))
    env = {**os.environ, "XLA_FLAGS": "--xla_force_host_platform_device_count=4", "JAX_PLATFORMS": "cpu",
           "PYTHONPATH": os.path.join(ROOT, "src")}
    code = ("import sys; sys.path.insert(0, sys.argv[3]); import test_torch_sharded as t; "
            "t._jax_main(sys.argv[1], sys.argv[2])")
    proc = subprocess.Popen([sys.executable, "-c", code, str(d / "in.pkl"), str(d / "out.pkl"),
                             os.path.join(ROOT, "tests")], env=env, cwd=ROOT)
    try:
        w2 = launch.spawn(drv.run_all, 2, "gloo", ([CASES[k] for k in W2] + [EDGE_SYNC_INT8], _spec_jobs(d)))
        w4 = launch.spawn(drv.run_cases, 4, "gloo", ([CASES[k] for k in W4] + [EDGE_SYNC, EDGE_SYNC_SPAN],))
        assert proc.wait(timeout=600) == 0
    finally:
        proc.kill()
    res = pickle.load(open(d / "out.pkl", "rb"))
    n2 = len(W2)
    return {"dir": d,
            "jax_w2": dict(zip(W2, res[:n2])), "jax_w4": dict(zip(W4, res[n2:])),
            "w2": dict(zip(W2, w2[0][0][:-1])), "w2_ranks": [r[0] for r in w2], "w2_edge_sync_int8": w2[0][0][-1],
            "w2_specs": [r[1] for r in w2],
            "w4": dict(zip(W4, w4[0][:-2])), "w4_edge_sync": w4[0][-2], "w4_edge_sync_span": w4[0][-1]}


def _assert_states_close(want, got, what):
    for key in ("params", "opt", "anchor", "residual"):
        assert len(want[key]) == len(got[key]), (what, key)
        for a, b in zip(want[key], got[key]):
            np.testing.assert_allclose(b, a, err_msg=f"{what} {key}", **STATE_TOL)
    assert want["step"] == got["step"]


def _assert_metrics_close(want, got, what):
    np.testing.assert_allclose(got["loss"], want["loss"], err_msg=f"{what} loss", **METRIC_TOL)
    np.testing.assert_allclose(got["grad_norm"], want["grad_norm"], err_msg=f"{what} grad_norm", **METRIC_TOL)
    assert [list(s) for s in got["steps"]] == [list(s) for s in want["steps"]]


# ---------------------------------------------------------------------------
# the refusals (first: no fixture has a process group up yet)
# ---------------------------------------------------------------------------


def test_a_mesh_without_a_process_group_raises_naming_the_launch():
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="spawn.*torchrun --nproc-per-node K"):
        sharding.client_mesh(2, device="cpu")
    spec = ExperimentSpec.parse(["topology.mesh_axes=clients:2", "run.num_rounds=2"])
    with pytest.raises(RuntimeError, match="initialised torch.distributed process group"):
        spec.build(device="cpu")


def test_a_mesh_larger_than_the_world_and_bad_axes_raise(world1):
    with pytest.raises(ValueError, match="2-rank client mesh but the process group has only 1"):
        sharding.client_mesh(2, device="cpu")
    with pytest.raises(ValueError, match="2-rank client mesh"):
        ExperimentSpec.parse(["topology.mesh_axes=clients:2"]).build(device="cpu")
    with pytest.raises(ValueError, match="mesh_axes"):
        ExperimentSpec.parse(["topology.mesh_axes=clients:two"]).build(device="cpu")


def test_nccl_with_two_ranks_on_one_device_raises_by_name(world1, monkeypatch):
    monkeypatch.setattr(dist, "get_backend", lambda group=None: "nccl")
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "2")
    with pytest.raises(ValueError, match="NCCL refuses two ranks on one GPU.*gloo"):
        sharding.client_mesh(1, device="cuda:0")
    with pytest.raises(ValueError, match="NCCL backend needs CUDA devices"):
        sharding.client_mesh(1, device="cpu")


def test_the_deadline_engine_refuses_a_mesh_in_jax_words(world1):
    spec = ExperimentSpec.parse(["topology.mesh_axes=clients:1", "deadline.enabled=true", "run.num_rounds=20",
                                 "run.eval_every=10"])
    with pytest.raises(ValueError, match=r"deadline engine is single-device \(the gated cloud sync selects "
                                         r"per-edge over the whole client axis\); drop the mesh"):
        spec.run_experiment(device="cpu")


def test_the_mesh_spec_round_trips_and_describes_itself():
    spec = ExperimentSpec.parse(["topology.mesh_axes=clients:2"])
    assert spec.topology.mesh_axes == "clients:2"
    assert ExperimentSpec.from_dict(spec.to_dict()) == spec
    assert "mesh=clients:2" in spec.describe()


# ---------------------------------------------------------------------------
# host-side plans: equal to JAX exactly
# ---------------------------------------------------------------------------

TREES = [("2,2,2,2,2,2,2,2", 4), ("4,2,1/3", 2), ("3,2,3,2/2,2/2", 2), ("16,12,10,7,5", 2),
         ("16,12,10,7,5", 4), ("3,2,3,2/4", 4), ("3,3", 1), ("5,5,5", 3)]


@pytest.mark.parametrize("fanouts,shards", TREES)
def test_shard_placement_equals_jax(fanouts, shards):
    js, ts = jhier.parse_fanouts(fanouts), thier.parse_fanouts(fanouts)
    jp, tp = jhier.plan_shard_placement(js, shards), thier.plan_shard_placement(ts, shards)
    assert (tp.num_shards, tp.capacity, tp.perm) == (jp.num_shards, jp.capacity, jp.perm)
    assert (tp.num_phantoms, tp.padded_clients, tp.describe()) == (jp.num_phantoms, jp.padded_clients, jp.describe())
    for name in ("valid", "gather_index", "positions"):
        np.testing.assert_array_equal(getattr(tp, name)(), getattr(jp, name)())
    w = np.arange(1, ts.num_clients + 1, dtype=np.float64)
    np.testing.assert_array_equal(tp.pad_weights(w), jp.pad_weights(w))
    for level in range(1, ts.depth):
        np.testing.assert_array_equal(tp.local_segments(level), jp.local_segments(level))
        assert tp.local_num_segments(level) == jp.local_num_segments(level)
    with pytest.raises(ValueError) as je:
        jp.local_segments(ts.depth)
    with pytest.raises(ValueError) as te:
        tp.local_segments(ts.depth)
    assert str(te.value) == str(je.value)


def test_shard_placement_errors_equal_jax():
    for fanouts, shards in (("5,5", 4), ("2,2,2/3", 4), ("3,2,3,2/2,2/2", 3), ("3,3", 0)):
        with pytest.raises(ValueError) as je:
            jhier.plan_shard_placement(jhier.parse_fanouts(fanouts), shards)
        with pytest.raises(ValueError) as te:
            thier.plan_shard_placement(thier.parse_fanouts(fanouts), shards)
        assert str(te.value) == str(je.value)


@pytest.mark.parametrize("fanouts,quotas,shards", [("16,12,10,7,5", (4, 3, 3, 2, 1), 2),
                                                    ("2,2,2,2", (1, 1, 1, 1), 4),
                                                    ("3,2,3,2/2,2/2", (2, 1, 2, 1), 2)])
def test_cohort_placement_equals_jax(fanouts, quotas, shards):
    js, ts = jhier.parse_fanouts(fanouts), thier.parse_fanouts(fanouts)
    assert thier.cohort_hierarchy(ts, quotas).parents == jhier.cohort_hierarchy(js, quotas).parents
    jp, tp = jhier.plan_cohort_placement(js, quotas, shards), thier.plan_cohort_placement(ts, quotas, shards)
    assert (tp.capacity, tp.perm, tp.spec.parents) == (jp.capacity, jp.perm, jp.spec.parents)
    np.testing.assert_array_equal(th._cohort_quotas(ts, sum(quotas) + 1), jh._cohort_quotas(js, sum(quotas) + 1))


class _FakeMesh:
    def __init__(self, shape):
        self.axis_names = tuple(shape)
        self.shape = dict(shape)


@pytest.mark.parametrize("shape", [{"clients": 4}, {"data": 16, "model": 16}, {"pod": 2, "data": 16, "model": 16}])
def test_topology_plans_equal_jax(shape):
    mesh = _FakeMesh(shape)
    jp = jtopo.plan_for_mesh(mesh, edges_per_pod=4, clients_per_edge=3)
    tp = ttopo.plan_for_mesh(mesh, edges_per_pod=4, clients_per_edge=3)
    fields = lambda p: (p.fed_axes, p.num_pods, p.edges_per_pod, p.num_clients, p.num_edges,
                        p.topology.num_edges, p.topology.clients_per_edge)
    assert fields(tp) == fields(jp)
    for level in (1, 2):
        assert ttopo.replica_groups(tp, level) == jtopo.replica_groups(jp, level)
    assert ttopo.edge_replica_groups(tp) == jtopo.edge_replica_groups(jp)
    assert [ttopo.pod_of_edge(tp, e) for e in range(tp.num_edges)] == [
        jtopo.pod_of_edge(jp, e) for e in range(jp.num_edges)]
    for fanouts in ("16,12,10,7,5", "3,2,3,2/2,2/2", "4,4,4,4"):
        jh_, th_ = jtopo.plan_for_hierarchy(mesh, jhier.parse_fanouts(fanouts)), ttopo.plan_for_hierarchy(
            mesh, thier.parse_fanouts(fanouts))
        assert fields(th_) == fields(jh_)
        assert th_.spec.parents == jh_.spec.parents
        for level in range(1, th_.spec.depth + 1):
            assert ttopo.replica_groups(th_.spec, level) == jtopo.replica_groups(jh_.spec, level)
    np.testing.assert_array_equal(ttopo.client_weights([1, 2.5]), jtopo.client_weights([1, 2.5]))


def test_topology_plan_of_a_real_client_mesh_equals_jax(world1):
    from repro.dist.sharding import client_mesh as jclient_mesh

    jp = jtopo.plan_for_mesh(jclient_mesh(1), edges_per_pod=2, clients_per_edge=3)
    tp = ttopo.plan_for_mesh(world1, edges_per_pod=2, clients_per_edge=3)
    assert (tp.fed_axes, tp.num_pods, tp.num_clients) == (jp.fed_axes, jp.num_pods, jp.num_clients)


@pytest.mark.parametrize("new_n", [2, 4, 16])
def test_reshard_clients_and_merge_opt_state_equal_jax(new_n):
    rng = np.random.default_rng(1)
    x = rng.normal(size=(4, 3, 2)).astype(np.float32)
    sizes = np.array([1.0, 2.0, 3.0, 4.0])
    jp, jsz = jreshard.reshard_clients({"w": jnp.asarray(x)}, sizes, new_n)
    tp, tsz = treshard.reshard_clients({"w": torch.as_tensor(x)}, sizes, new_n)
    np.testing.assert_allclose(tp["w"].numpy(), np.asarray(jp["w"]), rtol=1e-6, atol=1e-7)
    np.testing.assert_array_equal(tsz, jsz)
    jo = jreshard.merge_opt_state((jnp.asarray(x), jnp.asarray(3)), sizes, new_n)
    to = treshard.merge_opt_state((torch.as_tensor(x), torch.tensor(3)), sizes, new_n)
    np.testing.assert_allclose(to[0].numpy(), np.asarray(jo[0]), rtol=1e-6, atol=1e-7)
    assert int(to[1]) == int(jo[1]) == 3
    for bad in (3,):
        with pytest.raises(ValueError) as je:
            jreshard.reshard_clients({"w": jnp.asarray(x)}, sizes, bad)
        with pytest.raises(ValueError) as te:
            treshard.reshard_clients({"w": torch.as_tensor(x)}, sizes, bad)
        assert str(te.value) == str(je.value)


def test_to_mesh_takes_this_ranks_rows():
    """``fed_state_shardings`` + ``to_mesh`` on rank 1 of 2: the rows of its
    half, the step and the generator replicated."""
    mesh = sharding.ClientMesh(axis="clients", size=2, rank=1, group=None, device=torch.device("cpu"),
                               backend="gloo")
    cfg = th.HierFAVGConfig(kappa1=1, kappa2=1)
    state = th.init_state(torch.Generator(), {"w": torch.arange(3.0)}, drv.build_optimizer("momentum"),
                          th.FedTopology(2, 2), cfg)
    state = state._replace(params={"w": torch.arange(12.0).reshape(4, 3)})
    part = treshard.to_mesh(state, sharding.fed_state_shardings(mesh, "clients", state, 4))
    np.testing.assert_array_equal(part.params["w"].numpy(), np.arange(6.0, 12.0).reshape(2, 3))
    assert part.rng is state.rng and int(part.step) == 0
    specs = th.fed_state_partition_specs(state, "clients", 4)
    assert specs.params["w"] == "clients" and specs.step == "" and specs.anchor is None


def _incompat_cases():
    j_med = JAggregatorSpec.parse("weighted_mean/median")
    j_trim = JAggregatorSpec.parse("trimmed_mean:0.25/weighted_mean")
    from repro_torch.core.aggregation import AggregatorSpec as TAggregatorSpec

    t_med = TAggregatorSpec.parse("weighted_mean/median")
    t_trim = TAggregatorSpec.parse("trimmed_mean:0.25/weighted_mean")
    return [
        ({}, {}, "2,2,2,2", 4),
        ({"aggregators": j_med}, {"aggregators": t_med}, "2,2,2,2", 4),
        ({"aggregators": j_trim}, {"aggregators": t_trim}, "2,2,2,2", 4),
        ({"aggregators": j_trim}, {"aggregators": t_trim}, "4,2,1/3", 2),
        ({}, {}, "4,4", 4),
        ({"sync_opt_state": True, "delta_cloud": True}, {"sync_opt_state": True, "delta_cloud": True}, "2,2", 2),
    ]


@pytest.mark.parametrize("jkw,tkw,fanouts,shards", _incompat_cases())
def test_sharding_incompatibility_in_jax_words(jkw, tkw, fanouts, shards):
    jr = jh.sharding_incompatibility(jh.HierFAVGConfig(kappa1=2, kappa2=2, **jkw), jhier.parse_fanouts(fanouts),
                                     shards)
    tr = th.sharding_incompatibility(th.HierFAVGConfig(kappa1=2, kappa2=2, **tkw), thier.parse_fanouts(fanouts),
                                     shards)
    assert tr == jr
    other = jhier.plan_shard_placement(jhier.parse_fanouts("3,3"), 1)
    tother = thier.plan_shard_placement(thier.parse_fanouts("3,3"), 1)
    assert th.sharding_incompatibility(th.HierFAVGConfig(kappa1=2, kappa2=2), thier.parse_fanouts("2,2,2"), 1,
                                       placement=tother) == jh.sharding_incompatibility(
        jh.HierFAVGConfig(kappa1=2, kappa2=2), jhier.parse_fanouts("2,2,2"), 1, placement=other)


# ---------------------------------------------------------------------------
# a world of 1, in process
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", W1)
def test_world_of_one_matches_jax_and_the_single_device_superround(name, world1):
    case = CASES[name]
    sharding.reset_counts()
    got = drv.drive(case, world1)
    assert got["all_reduce"] == case.get("intervals", 2)  # one per cloud interval
    single = drv.drive(case)
    _assert_states_close(single, got, f"{name} vs the port's superround")
    _assert_metrics_close(single, got, f"{name} vs the port's superround")
    want = _jax_drive(case, 1)
    _assert_states_close(want, got, f"{name} vs JAX's 1-shard run")
    _assert_metrics_close(want, got, f"{name} vs JAX's 1-shard run")


@pytest.mark.parametrize("case", [
    dict(fanouts="3,3,3,3", kappas=(1, 2), level=1, mask=np.array([1, 0, 1] * 4, np.float32)),
    dict(fanouts="4,2,1,3", kappas=(1, 2), level=1, transport="int8_ef:64/identity",
         mask=np.array([1, 1, 1, 1, 0, 0, 1, 1, 0, 1], np.float32)),
    dict(fanouts="3,3,3,3", kappas=(1, 2), level=1, aggregators="trimmed_mean:0.25/weighted_mean",
         mask=np.array([1, 1, 0] * 4, np.float32)),
    dict(fanouts="3,2,3,2/2,2/2", kappas=(1, 2, 2), level=2, sync_opt_state=True, opt="momentum",
         mask=np.array([1] * 5 + [0] * 5, np.float32)),
], ids=["masked", "int8_ef", "trimmed", "depth3_level2"])
def test_sub_top_syncs_are_the_single_device_syncs_bit_for_bit(case, world1):
    sharding.reset_counts()
    got = drv.sync_once(case, world1)
    want = drv.sync_once(case)
    assert sharding.COUNTS["all_reduce"] == 0  # an edge sync makes no collective
    for key in ("params", "anchor", "opt"):
        for a, b in zip(want[key], got[key]):
            np.testing.assert_array_equal(b, a, err_msg=key)


def test_the_local_step_is_the_single_device_step_bit_for_bit():
    from repro_torch.optim import adam

    spec = thier.parse_fanouts("3,3")
    cfg = th.HierFAVGConfig(kappa1=1, kappa2=1)
    rng = np.random.default_rng(2)
    batch = {"c": torch.as_tensor(rng.normal(size=(6, drv.DIM)).astype(np.float32))}
    outs = []
    for step in (th.build_local_step(drv.quad_loss, adam(0.01)), th._sharded_local_step(drv.quad_loss, adam(0.01), None)):
        s = th.init_state(torch.Generator(), {"w": torch.ones(drv.DIM)}, adam(0.01), spec, cfg)
        s = step(s, batch)[0]
        got = drv.state_numpy(s)
        outs.append(got["params"] + got["opt"])
    for a, b in zip(*outs):
        np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------------
# spawned worlds of 2 and 4 against JAX's 2- and 4-shard runs
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", W2)
def test_world_of_two_matches_jax_two_shards(name, worlds):
    got, want = worlds["w2"][name], worlds["jax_w2"][name]
    assert got["all_reduce"] == CASES[name].get("intervals", 2)
    _assert_states_close(want, got, f"{name} at 2 ranks vs JAX's 2 shards")
    _assert_metrics_close(want, got, f"{name} at 2 ranks vs JAX's 2 shards")
    for other in worlds["w2_ranks"][1:]:  # every rank ends with the same canonical state
        for a, b in zip(got["params"], other[W2.index(name)]["params"]):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("name", W4)
def test_world_of_four_matches_jax_four_shards(name, worlds):
    got, want = worlds["w4"][name], worlds["jax_w4"][name]
    assert got["all_reduce"] == CASES[name].get("intervals", 2)
    _assert_states_close(want, got, f"{name} at 4 ranks vs JAX's 4 shards")
    _assert_metrics_close(want, got, f"{name} at 4 ranks vs JAX's 4 shards")
    if name == "ragged":
        assert thier.plan_shard_placement(thier.parse_fanouts(CASES[name]["fanouts"]), 4).num_phantoms > 0


def test_edge_syncs_at_four_and_two_ranks_are_the_single_device_syncs_bit_for_bit(worlds):
    for got, case in ((worlds["w4_edge_sync"], EDGE_SYNC), (worlds["w2_edge_sync_int8"], EDGE_SYNC_INT8)):
        single = drv.sync_once(case)
        for key in ("params", "anchor"):
            for a, b in zip(single[key], got[key]):
                np.testing.assert_array_equal(b, a)


def test_an_edge_sync_over_two_ranks_tracks_the_single_device_sync(worlds):
    got, single = worlds["w4_edge_sync_span"], drv.sync_once(EDGE_SYNC_SPAN)
    _assert_states_close(single, got, "an edge over 2 of 4 ranks vs one device")
    np.testing.assert_array_equal(got["params"][0][4:], single["params"][0][4:])  # the dead edge kept its rows


# ---------------------------------------------------------------------------
# the runner through topology.mesh_axes=clients:2
# ---------------------------------------------------------------------------


def test_the_runner_trains_whole_intervals_sharded_and_tracks_one_device(worlds):
    got = worlds["w2_specs"][0][0]
    want = drv.run_spec(MESH_SPEC)
    assert got["sharded"] and got["mesh_reason"] is None
    assert got["all_reduce"] == 2  # 6 rounds, kappa (2, 3): two cloud intervals
    # the two evals score the cloud model from one all-reduce each; the
    # gathers are the per-client metrics' (one an interval) and the 4
    # params leaves' at the end of the run, none at an eval
    assert got["eval_all_reduce"] == 2 and got["gather"] == 2 + 4
    for a, b in zip(want["params"], got["params"]):
        np.testing.assert_allclose(b, a, **STATE_TOL)
    rec, ref = got["history"], want["history"]
    np.testing.assert_allclose(rec["loss"], ref["loss"], rtol=1e-5)
    np.testing.assert_allclose(rec["grad_norm"], ref["grad_norm"], rtol=1e-5)
    assert rec["step"] == ref["step"] and rec["mask_alive"] == ref["mask_alive"]
    for a, b in zip(rec["accuracy"], ref["accuracy"]):
        assert (a is None) == (b is None) and (a is None or abs(a - b) < 0.02)
    for other in worlds["w2_specs"][1:]:
        assert other[0]["history"] == rec


def test_an_unshardable_schedule_runs_the_per_round_loop_on_every_rank(worlds):
    got = worlds["w2_specs"][0][1]
    assert not got["engine_built"] and got["all_reduce"] == 0
    assert "top-level" in got["mesh_reason"]
    assert got["history"]["round"] == list(range(6))
    want = drv.run_spec(MEDIAN)
    assert got["history"] == want["history"]  # the same replicated computation
    for a, b in zip(want["params"], got["params"]):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("name", list(PER_ROUND))
def test_the_per_round_loop_on_a_mesh_names_why(name, worlds):
    """An unaligned eval cadence, ``engine="per_round"`` and the rounds
    after the last whole interval run the per-round loop replicated on
    every rank, and ``_mesh_reason`` says so: the mesh is never dropped
    quietly. The first two run no sharded interval and equal the
    single-device run bit for bit; the third shards its two whole
    intervals (two all-reduces) and tracks it at the mesh tolerance."""
    overrides, reason = PER_ROUND[name]
    got = worlds["w2_specs"][0][5 + list(PER_ROUND).index(name)]
    assert got["mesh_reason"] == reason
    want = drv.run_spec(overrides)
    assert got["history"]["round"] == want["history"]["round"]
    if name == "trailing_round":
        assert got["sharded"] and got["all_reduce"] == 2
        np.testing.assert_allclose(got["history"]["loss"], want["history"]["loss"], rtol=1e-5)
        for a, b in zip(want["params"], got["params"]):
            np.testing.assert_allclose(b, a, **STATE_TOL)
    else:
        assert not got["sharded"] and got["all_reduce"] == 0
        assert got["history"] == want["history"]
        for a, b in zip(want["params"], got["params"]):
            np.testing.assert_array_equal(a, b)
    for other in worlds["w2_specs"][1:]:
        assert other[5 + list(PER_ROUND).index(name)]["mesh_reason"] == reason


def test_a_sharded_run_resumes_from_its_checkpoint_bit_for_bit_in_the_file_layout(worlds, tmp_path):
    straight, cut, resumed = worlds["w2_specs"][0][2:5]
    assert resumed["history"]["round"] == [3, 4, 5]
    for key in ("round", "step", "loss", "grad_norm", "mask_alive", "accuracy"):
        assert resumed["history"][key] == straight["history"][key][3:], key
    for part in ("params", "opt"):
        for a, b in zip(straight[part], resumed[part]):
            np.testing.assert_array_equal(a, b)
    single = drv.run_spec(CKPT + [f"run.checkpoint_dir={tmp_path}", "run.num_rounds=3"])
    d = worlds["dir"] / "cut"
    assert sorted(os.listdir(tmp_path)) == ["step_000000000006", "step_000000000006.COMMITTED"]
    assert {"step_000000000006", "step_000000000006.COMMITTED"} <= set(os.listdir(d))
    assert sorted(os.listdir(d / "step_000000000006")) == sorted(os.listdir(tmp_path / "step_000000000006"))
    mesh_ckpt = np.load(d / "step_000000000006" / "payload.npz")
    one_ckpt = np.load(tmp_path / "step_000000000006" / "payload.npz")
    assert sorted(mesh_ckpt.files) == sorted(one_ckpt.files)
    for k in one_ckpt.files:
        assert mesh_ckpt[k].shape == one_ckpt[k].shape and mesh_ckpt[k].dtype == one_ckpt[k].dtype, k
        if mesh_ckpt[k].dtype.kind == "f":
            np.testing.assert_allclose(mesh_ckpt[k], one_ckpt[k], **STATE_TOL)
