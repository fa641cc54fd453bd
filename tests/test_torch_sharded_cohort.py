"""The sharded cohort in the port against the JAX package, on the CPU
(ROADMAP.md Queue 1 item 12, first half: population scale x device scale).

- ``sharded_cohort_incompatibility``: JAX's words (stratified sampler only).
- ``ClientStateStore.gather_placed`` / ``scatter_placed``: JAX's rows, and a
  rank's positions alone touch only its own clients.
- A world of 1 in process: ``build_sharded_cohort_super_round`` against the
  port's single-device ``build_cohort_super_round`` and JAX's sharded cohort
  on a 1-device mesh, with sgd, and with momentum, ``sync_opt_state``,
  int8 error feedback and masks (params ``rtol=3e-6, atol=2e-7``, the
  cohort engine's own JAX tolerance being ``rtol=1e-5``: JAX's documented
  reassociation bound, ``src/repro/core/hierfavg.py:1886-1889``).
- A spawned world of 2: the runner on an ``n1m_cohort4096``-shaped spec at
  small size (128 virtual clients on 8 edges, stratified cohorts of 32,
  Adam) with ``topology.mesh_axes=clients:2`` against the single-device
  cohort run (history ``rtol=1e-5``, params at the mesh tolerance); one
  all-reduce per interval; rank 0's checkpointed store is the
  single-device store (rows at the mesh tolerance, touched ids equal)
  while the other rank's store holds its own clients' rows only; a run cut
  at its checkpoint and resumed is bit-equal to the straight one.
"""
import os
import sys

import numpy as np
import pytest
import torch.distributed as dist

import jax
import jax.numpy as jnp

from repro.core import hierfavg as jh
from repro.core import hierarchy as jhier
from repro.fed import client_store as jstore
from repro.fed import participation as jpart
from repro.fed.transport import TransportSpec as JTransportSpec
from repro import optim as joptim
from repro_torch.core import hierfavg as th
from repro_torch.core import hierarchy as thier
from repro_torch.dist import launch, sharding
from repro_torch.fed import client_store as tstore
from repro_torch.fed import participation as tpart

# the runs the spawned ranks make (``dist.launch.spawn`` hands them this
# process's sys.path, so they import it from here too)
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_sharded_runs as drv  # noqa: E402

STATE_TOL = dict(rtol=3e-6, atol=2e-7)
METRIC_TOL = dict(rtol=1e-5, atol=1e-7)
FANOUTS = "5,4,4,3"


def _cohorts(fanouts, cohort_size, intervals, seed=3):
    spec = thier.parse_fanouts(fanouts)
    sampler = tpart.StratifiedSampler(spec.num_clients, cohort_size, spec.segments(1), seed=seed)
    return [np.asarray(sampler.sample()) for _ in range(intervals)]


CASES = {
    "sgd": dict(fanouts=FANOUTS, cohort_size=8, kappas=(2, 2), cohorts=_cohorts(FANOUTS, 8, 2)),
    "momentum_int8_ef": dict(fanouts=FANOUTS, cohort_size=8, kappas=(2, 2), opt="momentum", sync_opt_state=True,
                             transport="int8_ef:64/int8_ef:64", cohorts=_cohorts(FANOUTS, 8, 2),
                             masks=[np.array([1, 1, 0, 1, 1, 1, 1, 1], np.float32)] + [np.ones(8, np.float32)] * 3),
}
# n1m_cohort4096 at small size (tests/test_torch_cohort.py's SMALL_N1M), Adam
SMALL_N1M = ["topology.num_edges=8", "topology.clients_per_edge=16", "data.virtual_clients=128",
             "participation.cohort_size=32", "participation.sampler=stratified", "run.num_rounds=4",
             "schedule.kappas=2,2", "run.eval_every=2", "model.optimizer=adam",
             "model.lr=0.01", "run.checkpoint_every=2"]
# clients straight under the cloud: slots take any client, so every rank
# keeps the whole store
DEPTH1 = ["topology.fanouts=16", "schedule.kappas=2", "participation.cohort_size=8",
          "participation.sampler=stratified", "run.num_rounds=3", "model.optimizer=adam", "model.lr=0.01",
          "data.num_samples=256", "data.partition=iid"]


def _jax_drive_cohort(case, num_shards):
    """``torch_sharded_runs.drive_cohort`` in JAX, sharded over a
    ``num_shards``-device mesh."""
    from repro.dist.sharding import batch_block_sharding, client_mesh, fed_state_shardings, mask_stack_sharding
    from jax.sharding import NamedSharding, PartitionSpec as P

    spec = jhier.parse_fanouts(case["fanouts"])
    c = case["cohort_size"]
    kw = {"transport": JTransportSpec.parse(case["transport"])} if case.get("transport") else {}
    part = jpart.ParticipationSpec(cohort_size=c, sampler="stratified")
    cfg = jh.HierFAVGConfig.multi_level(case["kappas"], sync_opt_state=bool(case.get("sync_opt_state")),
                                        participation=part, **kw)
    opt = joptim.momentum(0.1, 0.9) if case.get("opt") == "momentum" else joptim.sgd(0.1)
    centers, sizes = drv.quad_problem(spec.num_clients, case.get("seed", 0))
    k1, k2 = cfg.kappa1, cfg.kappa2_effective
    loss_fn = lambda p, b, _r: 0.5 * jnp.sum((p["w"] - b["c"]) ** 2)
    mesh = client_mesh(num_shards)
    placement = jhier.plan_cohort_placement(spec, jh._cohort_quotas(spec, c), num_shards)
    fn = jax.jit(jh.build_sharded_cohort_super_round(loss_fn, opt, spec, cfg, cohort_size=c, mesh=mesh,
                                                      placement=placement))
    gather, valid = placement.gather_index(), placement.valid()
    state = jh.init_cohort_state(jax.random.PRNGKey(0), {"w": jnp.zeros(drv.DIM)}, opt, cfg, c)
    state = jh.map_stacked_fed_state(state, lambda x: jnp.take(x, jnp.asarray(gather), axis=0), lambda x: x, c)
    state = jax.device_put(state, fed_state_shardings(mesh, "clients", state, placement.padded_clients))
    masks = case.get("masks")
    loss, gnorm = [], []
    for q, ids in enumerate(case["cohorts"]):
        block = jnp.broadcast_to(jnp.asarray(centers[ids]), (k2, k1, c, drv.DIM))
        block = jax.device_put({"c": jnp.take(block, jnp.asarray(gather), axis=2)},
                               batch_block_sharding(mesh, "clients"))
        w = jax.device_put(jnp.asarray(placement.pad_weights(sizes[ids].astype(np.float32))),
                           NamedSharding(mesh, P("clients")))
        dm = None
        if masks is not None:
            st = np.stack(masks[q * k2:(q + 1) * k2]).astype(np.float32)
            dm = jax.device_put(jnp.asarray(st[:, gather] * valid[None, :]), mask_stack_sharding(mesh, "clients"))
        state, m = fn(state, block, w, dm)
        m = jax.device_get(m)
        loss.append(np.asarray(m["loss"])[:, :, valid].mean(axis=(1, 2)))
        gnorm.append(np.sqrt(np.asarray(m["gsq"])[:, :, valid].sum(axis=2)).mean(axis=1))
    pos = jnp.asarray(placement.positions())
    state = jh.map_stacked_fed_state(state, lambda x: jnp.take(x, pos, axis=0), lambda x: x,
                                     placement.padded_clients)
    arr = lambda t: [] if t is None else [np.asarray(x) for x in jax.tree_util.tree_leaves(t)
                                          if getattr(x, "ndim", 0) >= 1]
    return {"params": arr(state.params), "opt": arr(state.opt_state), "anchor": arr(state.anchor),
            "residual": arr(state.residual), "step": int(state.step), "loss": np.stack(loss),
            "grad_norm": np.stack(gnorm)}


def _assert_close(want, got, what, keys=("params", "opt", "anchor", "residual")):
    for key in keys:
        assert len(want[key]) == len(got[key]), (what, key)
        for a, b in zip(want[key], got[key]):
            np.testing.assert_allclose(b, a, err_msg=f"{what} {key}", **STATE_TOL)
    np.testing.assert_allclose(got["loss"], want["loss"], err_msg=f"{what} loss", **METRIC_TOL)
    np.testing.assert_allclose(got["grad_norm"], want["grad_norm"], err_msg=f"{what} grad_norm", **METRIC_TOL)


@pytest.fixture
def world1():
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0, world_size=1)
    try:
        yield sharding.client_mesh(1, device="cpu")
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def cohort_world2(tmp_path_factory):
    d = tmp_path_factory.mktemp("cohort_w2")
    jobs = [(SMALL_N1M + [f"run.checkpoint_dir={d}/straight"], {}),
            (SMALL_N1M + [f"run.checkpoint_dir={d}/cut", "run.num_rounds=2"], {}),
            (SMALL_N1M + [f"run.checkpoint_dir={d}/cut"], {"resume": True}),
            (DEPTH1, {})]
    return launch.spawn(drv.run_specs, 2, "gloo", (jobs,))


# ---------------------------------------------------------------------------


@pytest.mark.parametrize("sampler,cohort,shards", [("stratified", 8, 2), ("uniform", 8, 2), ("round_robin", 8, 1),
                                                   ("stratified", 3, 2), ("stratified", 8, 5)])
def test_sharded_cohort_incompatibility_in_jax_words(sampler, cohort, shards):
    jcfg = jh.HierFAVGConfig(kappa1=2, kappa2=2, participation=jpart.ParticipationSpec(cohort, sampler))
    tcfg = th.HierFAVGConfig(kappa1=2, kappa2=2, participation=tpart.ParticipationSpec(cohort, sampler))
    js, ts = jhier.parse_fanouts(FANOUTS), thier.parse_fanouts(FANOUTS)
    assert th.sharded_cohort_incompatibility(tcfg, ts, cohort, shards) == jh.sharded_cohort_incompatibility(
        jcfg, js, cohort, shards)
    if sampler == "stratified" and cohort == 8:
        other = thier.plan_cohort_placement(ts, th._cohort_quotas(ts, 8), 1)
        jother = jhier.plan_cohort_placement(js, jh._cohort_quotas(js, 8), 1)
        assert th.sharded_cohort_incompatibility(tcfg, ts, 8, 2, placement=other) == \
            jh.sharded_cohort_incompatibility(jcfg, js, 8, 2, placement=jother)


def test_gather_placed_and_scatter_placed_are_jax_rows():
    spec = thier.parse_fanouts(FANOUTS)
    c = 8
    placement = thier.plan_cohort_placement(spec, th._cohort_quotas(spec, c), 2)
    jplacement = jhier.plan_cohort_placement(jhier.parse_fanouts(FANOUTS), jh._cohort_quotas(spec, c), 2)
    ids = _cohorts(FANOUTS, c, 1)[0]
    rows = np.arange(placement.padded_clients * 3, dtype=np.float32).reshape(-1, 3)
    jst = jstore.ClientStateStore(16, {"m": np.zeros(3, np.float32)})
    tst = tstore.ClientStateStore(16, {"m": np.zeros(3, np.float32)})
    jst.scatter_placed(ids, jplacement, {"m": rows})
    tst.scatter_placed(ids, placement, {"m": rows})
    np.testing.assert_array_equal(tst.state()["leaves"][0], jst.state()["leaves"][0])
    np.testing.assert_array_equal(tst.state()["touched"], jst.state()["touched"])
    np.testing.assert_array_equal(tst.gather_placed(ids, placement)["m"], np.asarray(jst.gather_placed(ids, jplacement)["m"]))
    # one rank's positions: its own slots' clients only, phantoms dropped
    rank1 = slice(placement.capacity, 2 * placement.capacity)
    mine = tstore.ClientStateStore(16, {"m": np.zeros(3, np.float32)})
    mine.scatter_placed(ids, placement, {"m": rows[rank1]}, positions=rank1)
    slots = [p for p in placement.perm[rank1] if p >= 0]
    assert sorted(np.flatnonzero(mine.state()["touched"])) == sorted(ids[slots].tolist())
    np.testing.assert_array_equal(mine.gather_placed(ids, placement, rank1)["m"][placement.valid()[rank1]],
                                  rows[rank1][placement.valid()[rank1]])


@pytest.mark.parametrize("name", list(CASES))
def test_world_of_one_matches_the_single_device_cohort_and_jax(name, world1):
    case = CASES[name]
    sharding.reset_counts()
    got = drv.drive_cohort(case, world1)
    assert got["all_reduce"] == len(case["cohorts"])
    _assert_close(drv.drive_cohort(case), got, f"{name} vs the port's cohort superround")
    _assert_close(_jax_drive_cohort(case, 1), got, f"{name} vs JAX's 1-shard sharded cohort")


def test_the_sharded_cohort_runner_tracks_the_single_device_run(cohort_world2):
    got = cohort_world2[0][0]
    want = drv.run_spec(SMALL_N1M)
    assert got["sharded"] and got["all_reduce"] == 2
    assert got["eval_all_reduce"] == 2  # each eval's cloud model: one all-reduce, no gather of the params
    rec, ref = got["history"], want["history"]
    for a, b in zip(rec["accuracy"], ref["accuracy"]):
        assert (a is None) == (b is None) and (a is None or abs(a - b) < 0.02)
    np.testing.assert_allclose(rec["loss"], ref["loss"], rtol=1e-5)
    np.testing.assert_allclose(rec["grad_norm"], ref["grad_norm"], rtol=1e-5)
    assert rec["step"] == ref["step"] and rec["mask_alive"] == ref["mask_alive"]
    for a, b in zip(want["params"] + want["opt"], got["params"] + got["opt"]):
        np.testing.assert_allclose(b, a, **STATE_TOL)
    # rank 0's store, merged at the last checkpoint, is the whole logical store
    np.testing.assert_array_equal(got["store"]["touched"], want["store"]["touched"])
    for a, b in zip(want["store"]["leaves"], got["store"]["leaves"]):
        np.testing.assert_allclose(b, a, rtol=3e-6, atol=1e-7)
    # the other rank's store holds the rows of its own edges' clients only
    spec = thier.as_hierarchy(th.FedTopology(8, 16))
    placement = thier.plan_cohort_placement(spec, th._cohort_quotas(spec, 32), 2)
    mine = np.flatnonzero(cohort_world2[1][0]["store"]["touched"])
    slots = [p for p in placement.perm[placement.capacity:] if p >= 0]
    edges = set(placement.spec.segments(1)[slots].tolist())
    assert mine.size and set(spec.segments(1)[mine].tolist()) <= edges
    assert cohort_world2[1][0]["history"] == rec


def test_a_sharded_cohort_run_resumes_bit_for_bit(cohort_world2):
    straight, cut, resumed = cohort_world2[0][:3]
    assert resumed["history"]["round"] == [2, 3]
    for key in ("step", "loss", "grad_norm", "mask_alive", "accuracy"):
        assert resumed["history"][key] == straight["history"][key][2:], key
    for a, b in zip(straight["params"] + straight["opt"], resumed["params"] + resumed["opt"]):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(straight["store"]["touched"], resumed["store"]["touched"])
    for a, b in zip(straight["store"]["leaves"], resumed["store"]["leaves"]):
        np.testing.assert_array_equal(a, b)


def test_a_depth_one_sharded_cohort_keeps_the_whole_store_on_every_rank(cohort_world2):
    got, other = cohort_world2[0][3], cohort_world2[1][3]
    want = drv.run_spec(DEPTH1)
    assert got["sharded"] and got["all_reduce"] == 3
    np.testing.assert_allclose(got["history"]["loss"], want["history"]["loss"], rtol=1e-5)
    for a, b in zip(want["params"] + want["opt"], got["params"] + got["opt"]):
        np.testing.assert_allclose(b, a, **STATE_TOL)
    for store in (got["store"], other["store"]):
        np.testing.assert_array_equal(store["touched"], want["store"]["touched"])
        for a, b in zip(want["store"]["leaves"], store["leaves"]):
            np.testing.assert_allclose(b, a, rtol=3e-6, atol=1e-7)
