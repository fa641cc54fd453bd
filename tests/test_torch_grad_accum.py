"""Microbatch accumulation and the fused train step in the port against the
JAX package, on the CPU (ROADMAP.md Queue 1 item 12, second half).

- ``_client_grads`` / ``build_local_step`` with ``grad_accum`` 2 and 4
  against JAX's ``_build_microbatch_grads`` / ``build_local_step``: the
  gradients (the microbatches' sum over ``grad_accum``), the last
  microbatch's per-client losses and the grad norm.
- ``build_train_step`` over a whole cloud interval of a two- and a
  three-level tree against JAX's ``build_train_step`` (its ``lax.switch``
  on the step): params after every step, and the level each step synced.
- ``build_super_round`` with ``grad_accum`` against JAX's.
- ``FederatedRunner(grad_accum=2)`` on ``quickstart`` (batches of 8 cut
  into 2 microbatches of 4) against JAX's runner with the same batches.
- The refusals in JAX's words: the megakernel keeps the superround, a mesh
  the per-round loop.

Tolerances: gradients, losses and grad norms ``rtol=1e-5, atol=1e-6``
(f32, one product order apart); params after a step ``rtol=1e-5,
atol=1e-6``; runner histories as ``tests/test_torch_runner.py``'s (loss and
grad norm ``rtol=1e-4``, final params ``atol=1e-4``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro import optim as joptim
from repro.core import hierfavg as jh
from repro.fed import runner as jrunner
from repro.fed import scenarios as jscen
from repro_torch import optim as toptim
from repro_torch.core import hierfavg as th
from repro_torch.data.pipeline import split_microbatches
from repro_torch.fed import scenarios as tscen
from repro_torch.testing.parity import assert_close, to_numpy

TOL = dict(rtol=1e-5, atol=1e-6)
D, C, B = 6, 3, 8  # features, classes, per-client batch


@pytest.fixture(autouse=True)
def _fresh_jax_caches():
    """Each test makes its JAX steps from empty caches. ``_jloss`` is one
    function object for every JAX step of this file; after
    ``_build_microbatch_grads(_jloss, 4)`` a later ``build_train_step(
    grad_accum=2)`` in the same process returned a stale trace (w[1,2,0]
    -2.4891 after step 1 where a fresh process and the port give -2.5998)."""
    jax.clear_caches()
    yield


def _jloss(params, batch, _rng):
    logits = batch["x"] @ params["w"] + params["b"]
    logz = jax.nn.logsumexp(logits, axis=-1)
    return jnp.mean(logz - jnp.take_along_axis(logits, batch["y"][:, None], axis=-1)[:, 0])


def _tloss(params, batch, _rng):
    logits = batch["x"] @ params["w"] + params["b"]
    logz = torch.logsumexp(logits, dim=-1)
    return torch.mean(logz - torch.gather(logits, -1, batch["y"][:, None].long())[:, 0])


def _problem(n, accum, steps=1, seed=0):
    """Stacked params (N, ...) and ``steps`` batches of leaves (accum, N, B/accum, ...)."""
    rng = np.random.default_rng(seed)
    params = {"w": rng.normal(size=(n, D, C)).astype(np.float32), "b": rng.normal(size=(n, C)).astype(np.float32)}
    x = rng.normal(size=(steps, n, B, D)).astype(np.float32)
    y = rng.integers(0, C, size=(steps, n, B)).astype(np.int32)
    split = split_microbatches(lambda d: d, accum) if accum > 1 else (lambda d: d)
    batches = [split({"x": x[s], "y": y[s]}) for s in range(steps)]
    return params, batches


def _t(tree):
    return {k: torch.as_tensor(np.asarray(v)) for k, v in tree.items()}


@pytest.mark.parametrize("accum", [2, 4])
def test_microbatch_grads_and_local_step_track_jax(accum):
    n = 3
    params, (batch,) = _problem(n, accum)
    assert batch["x"].shape == (accum, n, B // accum, D)
    rngs = jax.random.split(jax.random.PRNGKey(0), n)
    jg, jl = jh._build_microbatch_grads(_jloss, accum)({k: jnp.asarray(v) for k, v in params.items()},
                                                       {k: jnp.asarray(v) for k, v in batch.items()}, rngs)
    tg, tl = th._client_grads(_tloss, None, accum)(_t(params), _t(batch), torch.Generator())
    assert_close(to_numpy(tg), jax.device_get(jg), what="accumulated grads", **TOL)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    # the losses are the last microbatch's, not the whole batch's
    last = {k: v[-1] for k, v in batch.items()}
    _, last_losses = th._client_grads(_tloss, None)(_t(params), _t(last), torch.Generator())
    np.testing.assert_allclose(tl.numpy(), last_losses.numpy(), rtol=0, atol=0)

    cfg = jh.HierFAVGConfig(kappa1=1, kappa2=1)
    jstate = jh.init_state(jax.random.PRNGKey(1), {k: jnp.asarray(v[0]) for k, v in params.items()},
                           joptim.sgd(0.1), jh.FedTopology(1, n), cfg)
    jstate = jstate._replace(params={k: jnp.asarray(v) for k, v in params.items()})
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    js, jm = jh.build_local_step(_jloss, joptim.sgd(0.1), grad_accum=accum)(jstate, jbatch)
    tstate = th.init_state(torch.Generator(), _t(params), toptim.sgd(0.1), None,
                           th.HierFAVGConfig(kappa1=1, kappa2=1), already_stacked=True)
    ts, tm = th.build_local_step(_tloss, toptim.sgd(0.1), grad_accum=accum)(tstate, _t(batch))
    assert_close(to_numpy(ts.params), jax.device_get(js.params), what="params after the step", **TOL)
    for key in ("loss", "grad_norm"):
        np.testing.assert_allclose(float(tm[key]), float(jm[key]), **TOL, err_msg=key)


def _tree_case(kind):
    if kind == "two_level":
        return jh.FedTopology(2, 2), th.FedTopology(2, 2), jh.HierFAVGConfig(kappa1=2, kappa2=3), \
            th.HierFAVGConfig(kappa1=2, kappa2=3)
    from repro.core.hierarchy import parse_fanouts as jparse
    from repro_torch.core.hierarchy import parse_fanouts as tparse

    f = "2,1,2,1/2,2"
    return jparse(f), tparse(f), jh.HierFAVGConfig.multi_level((1, 2, 2)), th.HierFAVGConfig.multi_level((1, 2, 2))


@pytest.mark.parametrize("kind", ["two_level", "three_level"])
def test_train_step_over_a_cloud_interval_tracks_jax_level_by_level(kind, monkeypatch):
    jtopo, ttopo, jcfg, tcfg = _tree_case(kind)
    n = ttopo.num_clients
    steps = tcfg.cloud_interval
    params, batches = _problem(n, 2, steps, seed=1)
    sizes = np.arange(1, n + 1, dtype=np.float32)
    jstep = jax.jit(jh.build_train_step(_jloss, joptim.sgd(0.2), jtopo, jcfg, jnp.asarray(sizes), grad_accum=2))
    jstate = jh.init_state(jax.random.PRNGKey(1), {k: jnp.asarray(v[0]) for k, v in params.items()},
                           joptim.sgd(0.2), jtopo, jcfg)
    jstate = jstate._replace(params={k: jnp.asarray(v) for k, v in params.items()})
    synced = []
    build = th.build_level_sync

    def spy(topology, config, weights, level, **kw):
        sync = build(topology, config, weights, level, **kw)
        return lambda s, mask=None: (synced.append(level), sync(s, mask))[1]

    monkeypatch.setattr(th, "build_level_sync", spy)
    tstep = th.build_train_step(_tloss, toptim.sgd(0.2), ttopo, tcfg, torch.as_tensor(sizes), grad_accum=2)
    tstate = th.init_state(torch.Generator(), _t(params), toptim.sgd(0.2), None, tcfg, already_stacked=True)
    depth = len(tcfg.kappa_vector)
    for k, batch in enumerate(batches, start=1):
        jstate, jm = jstep(jstate, {key: jnp.asarray(v) for key, v in batch.items()})
        before = len(synced)
        tstate, tm = tstep(tstate, _t(batch))
        due = sum(1 for lvl in range(1, depth + 1) if k % tcfg.level_interval(lvl) == 0)
        assert synced[before:] == ([due] if due else []), f"step {k}"
        assert int(tm["step"]) == int(jm["step"]) == k
        assert_close(to_numpy(tstate.params), jax.device_get(jstate.params), what=f"params after step {k}", **TOL)
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), **TOL)
    assert synced[-1] == depth  # the interval ends with the cloud sync


def test_super_round_with_accumulation_tracks_jax():
    jtopo, ttopo, jcfg, tcfg = _tree_case("two_level")
    n, k1, k2 = 4, 2, 3
    params, flat = _problem(n, 2, k1 * k2, seed=2)
    block = {key: np.stack([b[key] for b in flat]).reshape((k2, k1) + flat[0][key].shape) for key in flat[0]}
    assert block["x"].shape == (k2, k1, 2, n, B // 2, D)
    sizes = np.ones(n, np.float32)
    jfn = jax.jit(jh.build_super_round(_jloss, joptim.sgd(0.2), jtopo, jcfg, jnp.asarray(sizes), grad_accum=2))
    jstate = jh.init_state(jax.random.PRNGKey(1), {k: jnp.asarray(v[0]) for k, v in params.items()},
                           joptim.sgd(0.2), jtopo, jcfg)
    jstate = jstate._replace(params={k: jnp.asarray(v) for k, v in params.items()})
    js, jm = jfn(jstate, {k: jnp.asarray(v) for k, v in block.items()})
    tfn = th.build_super_round(_tloss, toptim.sgd(0.2), ttopo, tcfg, torch.as_tensor(sizes), grad_accum=2)
    ts, tm = tfn(th.init_state(torch.Generator(), _t(params), toptim.sgd(0.2), None, tcfg, already_stacked=True),
                 _t(block))
    assert_close(to_numpy(ts.params), jax.device_get(js.params), what="params after the interval", **TOL)
    for key in ("loss", "grad_norm"):
        np.testing.assert_allclose(tm[key].numpy(), np.asarray(jm[key]), **TOL, err_msg=key)
    assert tm["step"].tolist() == np.asarray(jm["step"]).tolist()


QUICK = ["run.num_rounds=8"]


def _jax_accum_runner(overrides, accum, engine="auto"):
    jspec = jscen.get("quickstart", overrides=overrides + [f"run.engine={engine}"])
    jr = jspec.build()
    jr.batcher.batch_fn = split_microbatches(jr.batcher.batch_fn, accum)  # numpy in, numpy out
    return jspec, jrunner.FederatedRunner(
        loss_fn=jr.loss_fn, optimizer=jr.optimizer, topology=jr.topology, hier_config=jr.hier_config,
        data_sizes=np.asarray(jr.weights), batcher=jr.batcher, runner_config=jr.cfg, eval_fn=jr.eval_fn,
        costs=jr.costs, grad_accum=accum)


def test_runner_with_grad_accum_tracks_jax():
    jspec, jr = _jax_accum_runner(QUICK, 2)
    np_params = jax.device_get(jspec.init_params(jax.random.PRNGKey(jspec.run.seed + 1)))
    js = jr.run(jr.init(jax.random.PRNGKey(jspec.run.seed), np_params))
    tspec = tscen.get("quickstart", overrides=QUICK)
    tr = tspec.build(device="cpu", grad_accum=2)
    assert tr.grad_accum == 2
    ts = tr.run(tr.init(torch.Generator().manual_seed(tspec.run.seed), tspec.params_from_numpy(np_params, "cpu")))
    assert tr._engine is not None  # whole intervals through the superround engine
    assert len(tr.history) == len(jr.history) == 8
    for a, b in zip(jr.history, tr.history):
        assert (b.round, b.step) == (a.round, a.step)
        assert b.loss == pytest.approx(a.loss, rel=1e-4), f"round {a.round} loss"
        assert b.grad_norm == pytest.approx(a.grad_norm, rel=1e-4), f"round {a.round} grad_norm"
        assert (a.accuracy is None) == (b.accuracy is None)
        if a.accuracy is not None:
            assert abs(b.accuracy - a.accuracy) <= 0.01
    assert_close(to_numpy(ts.params), jax.device_get(js.params), rtol=0.0, atol=1e-4, what="final params")


def test_the_megakernel_refuses_accumulation_in_jax_words():
    want = "microbatch accumulation keeps the scan-fused path"
    _, jr = _jax_accum_runner(["run.num_rounds=2"], 2, engine="megakernel")
    assert jr._check_megakernel() == want
    tr = tscen.get("quickstart", overrides=["run.num_rounds=2", "run.engine=megakernel"]).build(
        device="cpu", grad_accum=2)
    assert tr._check_megakernel() == want
    state = tr.run(tr.init(torch.Generator().manual_seed(0), tscen.get("quickstart").init_params(1, "cpu")))
    assert not tr._engine.uses_megakernel and tr._engine.megakernel_reason == want
    assert int(state.step) == 8


def test_a_mesh_refuses_accumulation_in_jax_words():
    want = "grad_accum > 1 has no sharded block layout yet"
    from repro.dist.sharding import client_mesh as jclient_mesh

    jspec, jr = _jax_accum_runner(["run.num_rounds=2"], 2)
    jr.mesh = jclient_mesh(1)
    assert not jr._superround_eligible(0) and jr._mesh_reason == want
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0, world_size=1)
    try:
        spec = tscen.get("quickstart", overrides=["run.num_rounds=2", "topology.mesh_axes=clients:1"])
        tr = spec.build(device="cpu", grad_accum=2)
        state = tr.run(tr.init(torch.Generator().manual_seed(0), spec.init_params(1, "cpu")))
        assert tr._mesh_reason == want and tr._engine is None  # the per-round loop, replicated
        assert int(state.step) == 8
    finally:
        dist.destroy_process_group()
