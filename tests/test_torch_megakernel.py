"""The megakernel slice on the CPU: K3 ``edge_interval``'s plain version
against the JAX Pallas kernel (interpret mode) and its oracle, the port's
client-blocked ``build_megakernel_super_round`` against JAX's and against
the port's own superround, the eligibility reasons, and the runner's
``engine="megakernel"`` path against the JAX run.

Tolerances: K3 ``rtol=3e-6, atol=5e-7`` (the JAX kernel-vs-oracle
tolerance: the same f32 steps, contractions summed in another order); the
lowering ``rtol=1e-5, atol=1e-6`` (the JAX lowering-vs-superround
tolerance: only the order of the mean and metric sums differs); runner
histories as ``tests/test_torch_runner.py`` (loss ``rtol=1e-4``, accuracy
0.01, final params ``atol=1e-4``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import optim as joptim
from repro.core import hierfavg as jh
from repro.core.hierarchy import parse_fanouts as jparse
from repro.fed import api as japi
from repro.fed import transport as jtransport
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch import optim as toptim
from repro_torch.core import aggregation
from repro_torch.core import hierfavg as th
from repro_torch.core.hierarchy import parse_fanouts as tparse
from repro_torch.fed import api as tapi
from repro_torch.fed import runner as trunner
from repro_torch.fed import transport as ttransport
from repro_torch.kernels import megakernel as mk
from repro_torch.kernels import ops as tops
from repro_torch.testing.parity import assert_close, to_numpy

K3_TOL = dict(rtol=3e-6, atol=5e-7)
LOWERING_TOL = dict(rtol=1e-5, atol=1e-6)


@pytest.fixture(autouse=True)
def _interpret():
    jops.set_interpret(True)
    yield
    jops.set_interpret(None)


def _k3_inputs(rng, n, k1, b, feat, out, mom):
    p = feat * out
    return (
        (rng.normal(size=(n, p)) * 0.1).astype(np.float32),
        rng.normal(size=(n, k1, b, feat)).astype(np.float32),
        rng.normal(size=(n, k1, b, out)).astype(np.float32),
        rng.uniform(1, 3, n).astype(np.float32),
        (rng.normal(size=(n, p)) * 0.01).astype(np.float32) if mom else None,
    )


def _t(a):
    return None if a is None else torch.from_numpy(a)


def _j(a):
    return None if a is None else jnp.asarray(a)


# -- K3: the plain version against the Pallas kernel and the oracle ------------


@pytest.mark.parametrize(
    "n,e,k1,b,feat,out,mom",
    [
        (8, 2, 3, 2, 4, 3, 0.0),
        (16, 4, 2, 1, 8, 5, 0.9),
        (8, 2, 4, 2, 6, 2, 0.9),
        (8, 1, 2, 3, 4, 4, 0.0),  # one edge: the cloud mean
        (32, 2, 4, 1, 64, 256, 0.9),  # 16 clients per edge
        (24, 2, 3, 2, 16, 64, 0.0),  # 12 clients per edge
    ],
)
def test_edge_interval_plain_matches_pallas_kernel_and_oracle(rng, n, e, k1, b, feat, out, mom):
    params, x, y, w, mu = _k3_inputs(rng, n, k1, b, feat, out, mom)
    kw = dict(num_edges=e, feat=feat, lr=0.1, momentum=mom)
    got = tops.edge_interval(_t(params), _t(x), _t(y), _t(w), mu=_t(mu), **kw)
    pallas = jops.edge_interval(_j(params), _j(x), _j(y), _j(w), mu=_j(mu), **kw)
    oracle = jref.edge_interval_ref(_j(params), _j(x), _j(y), _j(w), e, feat=feat, lr=0.1, momentum=mom, mu=_j(mu))
    for want, what in ((pallas, "pallas"), (oracle, "oracle")):
        assert_close(to_numpy(list(got)), [np.asarray(v) for v in want], **K3_TOL, what=f"K3 vs {what}")
    assert got[1].dtype == torch.float32 and got[1].shape == (n, k1)


def test_edge_interval_plain_keeps_bf16_rows_and_mu():
    rng = np.random.default_rng(1)
    params, x, y, w, mu = _k3_inputs(rng, 8, 3, 2, 4, 3, 0.9)
    kw = dict(num_edges=2, feat=4, lr=0.1, momentum=0.9)
    got = tops.edge_interval(_t(params).bfloat16(), _t(x), _t(y), _t(w), mu=_t(mu).bfloat16(), **kw)
    want = jref.edge_interval_ref(_j(params).astype(jnp.bfloat16), _j(x), _j(y), _j(w), 2, feat=4, lr=0.1,
                                  momentum=0.9, mu=_j(mu).astype(jnp.bfloat16))
    assert [t.dtype for t in got] == [torch.bfloat16, torch.float32, torch.bfloat16]
    # f32 steps in both; the rows round to bf16 once, so they may sit one
    # bf16 ulp apart
    for a, b_, name in zip(to_numpy(list(got)), want, ("params", "losses", "mu")):
        b_ = np.asarray(b_).astype(np.float32)
        ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(b_), 1e-30))) - 7) if name != "losses" else 0.0
        assert np.all(np.abs(a - b_) <= ulp + K3_TOL["atol"] + K3_TOL["rtol"] * np.abs(b_)), name


def test_edge_interval_momentum_zero_leaves_mu():
    rng = np.random.default_rng(2)
    params, x, y, w, _ = _k3_inputs(rng, 4, 2, 1, 3, 2, 0.0)
    mu = torch.randn(4, 6)
    _, _, mu_out = tops.edge_interval(_t(params), _t(x), _t(y), _t(w), num_edges=2, feat=3, lr=0.1, mu=mu)
    assert torch.equal(mu_out, mu)
    _, _, zeros = tops.edge_interval(_t(params), _t(x), _t(y), _t(w), num_edges=2, feat=3, lr=0.1)
    assert torch.equal(zeros, torch.zeros(4, 6))


def test_edge_interval_zero_weight_edge_is_not_finite_as_in_jax():
    rng = np.random.default_rng(3)
    params, x, y, w, _ = _k3_inputs(rng, 4, 2, 1, 3, 2, 0.0)
    w[:2] = 0.0
    got = tops.edge_interval(_t(params), _t(x), _t(y), _t(w), num_edges=2, feat=3, lr=0.1)[0]
    want = np.asarray(jref.edge_interval_ref(_j(params), _j(x), _j(y), _j(w), 2, feat=3, lr=0.1)[0])
    assert not torch.isfinite(got[:2]).any() and not np.isfinite(want[:2]).any()
    np.testing.assert_allclose(got[2:].numpy(), want[2:], **K3_TOL)


def test_plain_k3_equals_one_superround_interval():
    """One edge interval of linear MSE clients (E 1, kappa2 1: the cloud
    mean is the edge mean) through the port's superround equals one K3
    call (the JAX test's tolerance for the same check)."""
    rng = np.random.default_rng(4)
    n, k1, b, feat, out = 8, 3, 2, 4, 3
    topo, config = th.FedTopology(1, n), th.HierFAVGConfig(kappa1=k1, kappa2=1)
    w = torch.from_numpy(rng.uniform(1, 3, n).astype(np.float32))

    def loss_fn(p, batch, _rng):
        return torch.mean(torch.square(batch["x"] @ p["w"] - batch["y"]))

    p0 = {"w": torch.from_numpy((rng.normal(size=(feat, out)) * 0.1).astype(np.float32))}
    state = th.init_state(torch.Generator().manual_seed(0), p0, toptim.sgd(0.1), topo, config)
    start = state.params["w"].reshape(n, feat * out).clone()
    x = torch.from_numpy(rng.normal(size=(1, k1, n, b, feat)).astype(np.float32))
    y = torch.from_numpy(rng.normal(size=(1, k1, n, b, out)).astype(np.float32))
    sb, m = th.build_super_round(loss_fn, toptim.sgd(0.1), topo, config, w)(state, {"x": x, "y": y})
    gp, gl, _ = tops.edge_interval(start, x[0].transpose(0, 1), y[0].transpose(0, 1), w, num_edges=1, feat=feat,
                                   lr=0.1)
    np.testing.assert_allclose(sb.params["w"].reshape(n, -1).numpy(), gp.numpy(), rtol=3e-6, atol=1e-6)
    np.testing.assert_allclose(float(torch.mean(gl)), float(m["loss"][0]), rtol=1e-6)


@pytest.mark.parametrize(
    "case",
    ["edges", "feat", "batch", "targets", "momentum"],
)
def test_edge_interval_raises_like_jax(case):
    n, k1, b, feat, out = 8, 2, 1, 4, 3
    params = np.zeros((n, feat * out), np.float32)
    x, y = np.zeros((n, k1, b, feat), np.float32), np.zeros((n, k1, b, out), np.float32)
    w = np.ones(n, np.float32)
    kw = dict(num_edges=2, feat=feat, lr=0.1)
    if case == "edges":
        kw["num_edges"] = 3
    elif case == "feat":
        kw["feat"] = 5
    elif case == "batch":
        x = x[:4]
    elif case == "targets":
        y = y[:, :1]
    else:
        kw["momentum"] = 0.9
    with pytest.raises(ValueError) as jerr:
        jops.edge_interval(_j(params), _j(x), _j(y), _j(w), **kw)
    with pytest.raises(ValueError) as terr:
        tops.edge_interval(_t(params), _t(x), _t(y), _t(w), **kw)
    assert str(terr.value) == str(jerr.value)


def test_edge_interval_refuses_devices_other_than_cpu_and_cuda():
    p = torch.empty(4, 6, device="meta")
    with pytest.raises(ValueError, match="CPU .* or CUDA"):
        mk.edge_interval(p, torch.empty(4, 1, 1, 3, device="meta"), torch.empty(4, 1, 1, 2, device="meta"),
                         torch.empty(4, device="meta"), num_edges=2, feat=3, lr=0.1)


def test_edge_interval_launch_count_stays_zero_on_cpu():
    mk.reset_launch_counts()
    rng = np.random.default_rng(5)
    params, x, y, w, _ = _k3_inputs(rng, 4, 2, 1, 3, 2, 0.0)
    tops.edge_interval(_t(params), _t(x), _t(y), _t(w), num_edges=2, feat=3, lr=0.1)
    assert mk.LAUNCHES == {"edge_interval": 0}


# -- the client-blocked lowering -------------------------------------------------


def _mk_problem(rng, n, feat=5, out=3):
    p0 = {"w": (rng.normal(size=(feat, out)) * 0.1).astype(np.float32), "b": np.zeros((out,), np.float32)}

    def batches(k2, k1, b=2):
        return {"x": rng.normal(size=(k2, k1, n, b, feat)).astype(np.float32),
                "y": rng.normal(size=(k2, k1, n, b, out)).astype(np.float32)}

    return p0, batches


def _jloss(p, batch, _rng):
    return jnp.mean(jnp.square(batch["x"] @ p["w"] + p["b"] - batch["y"]))


def _tloss(p, batch, _rng):
    return torch.mean(torch.square(batch["x"] @ p["w"] + p["b"] - batch["y"]))


def _opts(name):
    if name == "sgd":
        return joptim.sgd(0.1), toptim.sgd(0.1)
    if name == "momentum":
        return joptim.momentum(0.1, 0.9), toptim.momentum(0.1, 0.9)
    return joptim.adam(0.01), toptim.adam(0.01)


def _tstate(p0, opt, topo, config):
    return th.init_state(torch.Generator().manual_seed(0), {k: torch.from_numpy(v.copy()) for k, v in p0.items()},
                         opt, topo, config)


@pytest.mark.parametrize("opt_name", ["sgd", "momentum"])
@pytest.mark.parametrize("block_clients", [None, 1, 2, 4])
def test_blocked_super_round_matches_jax_and_the_superround(rng, opt_name, block_clients):
    n, e, k1, k2 = 8, 2, 3, 4
    jopt, topt = _opts(opt_name)
    jtopo, ttopo = jh.FedTopology(e, n // e), th.FedTopology(e, n // e)
    jcfg, tcfg = jh.HierFAVGConfig(kappa1=k1, kappa2=k2), th.HierFAVGConfig(kappa1=k1, kappa2=k2)
    w = rng.uniform(1, 3, n).astype(np.float32)
    p0, batches = _mk_problem(rng, n)
    blk = batches(k2, k1)
    jstate = jh.init_state(jax.random.PRNGKey(0), jax.tree_util.tree_map(jnp.asarray, p0), jopt, jtopo, jcfg)
    jmega = jax.jit(jh.build_megakernel_super_round(_jloss, jopt, jtopo, jcfg, jnp.asarray(w),
                                                    block_clients=block_clients))
    js, jm = jmega(jstate, jax.tree_util.tree_map(jnp.asarray, blk))
    tblk = {k: torch.from_numpy(v) for k, v in blk.items()}
    tmega = th.build_megakernel_super_round(_tloss, topt, ttopo, tcfg, torch.from_numpy(w),
                                            block_clients=block_clients)
    ms, mm = tmega(_tstate(p0, topt, ttopo, tcfg), tblk)
    ss, sm = th.build_super_round(_tloss, topt, ttopo, tcfg, torch.from_numpy(w))(_tstate(p0, topt, ttopo, tcfg), tblk)
    # against JAX's lowering
    assert_close(to_numpy(ms.params), jax.device_get(js.params), **LOWERING_TOL, what="params vs JAX")
    if opt_name == "momentum":
        assert_close(to_numpy(ms.opt_state[0].trace), jax.device_get(js.opt_state[0].trace), **LOWERING_TOL,
                     what="trace vs JAX")
    for key in ("loss", "grad_norm"):
        np.testing.assert_allclose(mm[key].numpy(), np.asarray(jm[key]), rtol=1e-5, err_msg=key)
    np.testing.assert_array_equal(mm["step"].numpy(), np.asarray(jm["step"]))
    assert int(ms.step) == int(js.step)
    # against the port's own superround: same steps, same generator state
    assert_close(to_numpy(ms.params), to_numpy(ss.params), **LOWERING_TOL, what="params vs superround")
    assert_close(to_numpy(ms.opt_state), to_numpy(ss.opt_state), **LOWERING_TOL, what="opt state vs superround")
    for key in ("loss", "grad_norm"):
        np.testing.assert_allclose(mm[key].numpy(), sm[key].numpy(), rtol=1e-5, err_msg=key)
    assert torch.equal(mm["step"], sm["step"]) and int(ms.step) == int(ss.step)
    assert torch.equal(ms.rng.get_state(), ss.rng.get_state())


def test_blocked_super_round_takes_one_grouped_mean_per_leaf_per_interval(rng, monkeypatch):
    calls = []
    real = aggregation.ops.grouped_mean
    monkeypatch.setattr(aggregation.ops, "grouped_mean", lambda x, w, g: calls.append(g) or real(x, w, g))
    n, e, k1, k2 = 8, 2, 2, 3
    p0, batches = _mk_problem(rng, n)
    topo, cfg = th.FedTopology(e, n // e), th.HierFAVGConfig(kappa1=k1, kappa2=k2)
    fn = th.build_megakernel_super_round(_tloss, toptim.sgd(0.1), topo, cfg, torch.ones(n))
    fn(_tstate(p0, toptim.sgd(0.1), topo, cfg), {k: torch.from_numpy(v) for k, v in batches(k2, k1).items()})
    # two leaves; edge, edge, then one flat cloud mean (G = 1)
    assert calls == [e, e, e, e, 1, 1]


def test_blocked_super_round_rejects_masks(rng):
    n, e = 4, 2
    p0, batches = _mk_problem(rng, n)
    topo, cfg = th.FedTopology(e, n // e), th.HierFAVGConfig(kappa1=2, kappa2=2)
    fn = th.build_megakernel_super_round(_tloss, toptim.sgd(0.1), topo, cfg, torch.ones(n))
    with pytest.raises(TypeError, match="survival masks"):
        fn(_tstate(p0, toptim.sgd(0.1), topo, cfg), {k: torch.from_numpy(v) for k, v in batches(2, 2).items()},
           torch.ones(2, n))


def test_blocked_super_round_rejects_unstackable_opt_state(rng):
    n, e = 4, 2
    p0, batches = _mk_problem(rng, n)
    topo, cfg = th.FedTopology(e, n // e), th.HierFAVGConfig(kappa1=2, kappa2=2)
    _, adam = _opts("adam")
    fn = th.build_megakernel_super_round(_tloss, adam, topo, cfg, torch.ones(n))
    blk = {k: torch.from_numpy(v) for k, v in batches(2, 2).items()}
    fn(_tstate(p0, adam, topo, cfg), blk)  # adam's stacked f32 moments block fine
    state = _tstate(p0, adam, topo, cfg)
    count, mu, nu = state.opt_state[0]
    bad = (type(state.opt_state[0])(count, {k: v[: n - 1] for k, v in mu.items()}, nu), state.opt_state[1])
    with pytest.raises(ValueError, match="optimizer state leaves"):
        fn(state._replace(opt_state=bad), blk)


def test_blocked_super_round_rejects_a_block_that_splits_an_edge(rng):
    p0, batches = _mk_problem(rng, 8)
    topo, cfg = th.FedTopology(2, 4), th.HierFAVGConfig(kappa1=2, kappa2=2)
    fn = th.build_megakernel_super_round(_tloss, toptim.sgd(0.1), topo, cfg, torch.ones(8), block_clients=3)
    with pytest.raises(ValueError, match="does not divide"):
        fn(_tstate(p0, toptim.sgd(0.1), topo, cfg), {k: torch.from_numpy(v) for k, v in batches(2, 2).items()})


@pytest.mark.parametrize("cpe,bytes_per_client", [(8, 1_228_840), (8, 1), (6, 3 << 20), (5, 5 << 20), (12, 700_000)])
def test_block_size_follows_jax(cpe, bytes_per_client):
    assert th._megakernel_block_clients(cpe, bytes_per_client) == jh._megakernel_block_clients(cpe, bytes_per_client)


# -- eligibility ------------------------------------------------------------------


def _configs():
    """(name, JAX topology and config, port topology and config, grad_accum)."""
    def both(tree, kappas, grad_accum=1, **kw):
        jt = jparse(tree) if tree else jh.FedTopology(2, 4)
        tt = tparse(tree) if tree else th.FedTopology(2, 4)
        jkw, tkw = dict(kw), dict(kw)
        if "transport" in kw:
            jkw["transport"] = jtransport.TransportSpec.parse(kw["transport"])
            tkw["transport"] = ttransport.TransportSpec.parse(kw["transport"])
        return (jt, jh.HierFAVGConfig.multi_level(kappas, **jkw), tt, th.HierFAVGConfig.multi_level(kappas, **tkw),
                grad_accum)

    return {
        "eligible": both(None, (2, 2)),
        "delta_cloud": both(None, (2, 2), delta_cloud=True),
        "transport": both(None, (2, 2), transport="identity/int8"),
        "sync_opt_state": both(None, (2, 2), sync_opt_state=True),
        "microbatch": both(None, (2, 2), grad_accum=2),
        "ragged": both("5,3/2", (2, 2)),
        "three_level": both("2,2,2,2/2,2/2", (2, 2, 2)),
        "uniform_fanouts": both("4,4,4/3", (2, 3)),
    }


@pytest.mark.parametrize("name", sorted(_configs()))
def test_megakernel_incompatibility_matches_jax(name):
    jt, jc, tt, tc, ga = _configs()[name]
    want = jh.megakernel_incompatibility(jc, jt, grad_accum=ga)
    assert th.megakernel_incompatibility(tc, tt, grad_accum=ga) == want
    assert (want is None) == (name in ("eligible", "uniform_fanouts"))


def test_build_megakernel_super_round_raises_on_incompatible():
    topo = th.FedTopology(2, 2)
    cfg = th.HierFAVGConfig(kappa1=2, kappa2=2, delta_cloud=True)
    with pytest.raises(ValueError, match="megakernel"):
        th.build_megakernel_super_round(_tloss, toptim.sgd(0.1), topo, cfg, torch.ones(4))


# -- the runner -------------------------------------------------------------------


SPEC = ["topology.num_edges=2", "topology.clients_per_edge=4", "schedule.kappas=2,2", "data.num_samples=320",
        "data.batch_size=4", "run.num_rounds=4", "run.eval_every=0", "cost.workload=none"]


def _run_both(overrides):
    jspec = japi.ExperimentSpec.parse(SPEC + overrides)
    tspec = tapi.ExperimentSpec.parse(SPEC + overrides)
    np_params = jax.device_get(jspec.init_params(jax.random.PRNGKey(jspec.run.seed + 1)))
    jr, js = jspec.run_experiment()
    tr, ts = tspec.run_experiment(device="cpu", params=tspec.params_from_numpy(np_params, "cpu"))
    return (jr, js), (tr, ts), np_params


@pytest.mark.parametrize("overrides", [
    ["run.engine=megakernel"],
    ["run.engine=megakernel", "run.num_rounds=9", "run.eval_every=2", "model.optimizer=adam", "model.lr=0.01"],
])
def test_runner_megakernel_tracks_jax(overrides):
    (jr, js), (tr, ts), _ = _run_both(overrides)
    assert jr._engine.uses_megakernel and tr._engine.uses_megakernel
    assert tr._engine.megakernel_reason is None and tr._megakernel_reason is None
    assert len(tr.history) == len(jr.history)
    for a, b in zip(jr.history, tr.history):
        assert (b.round, b.step) == (a.round, a.step)
        assert b.loss == pytest.approx(a.loss, rel=1e-4), f"round {a.round} loss"
        assert b.grad_norm == pytest.approx(a.grad_norm, rel=1e-4), f"round {a.round} grad_norm"
        assert (a.accuracy is None) == (b.accuracy is None)
        if a.accuracy is not None:
            assert abs(b.accuracy - a.accuracy) <= 0.01
    assert_close(to_numpy(ts.params), jax.device_get(js.params), rtol=0.0, atol=1e-4, what="final params")


def test_runner_megakernel_matches_the_port_superround():
    spec = tapi.ExperimentSpec.parse(SPEC)
    params = spec.init_params(1, "cpu")
    runs = {}
    for engine in ("superround", "megakernel"):
        runner, state = spec.with_overrides([f"run.engine={engine}"]).run_experiment(
            device="cpu", params={k: v.clone() for k, v in params.items()})
        runs[engine] = (runner, state)
    (rs, ss), (rm, sm) = runs["superround"], runs["megakernel"]
    assert rm._engine.uses_megakernel and not rs._engine.uses_megakernel
    assert_close(to_numpy(sm.params), to_numpy(ss.params), **LOWERING_TOL, what="params")
    assert torch.equal(sm.rng.get_state(), ss.rng.get_state())
    for a, b in zip(rs.history, rm.history):
        assert a.step == b.step
        assert b.loss == pytest.approx(a.loss, rel=1e-5)
        assert b.grad_norm == pytest.approx(a.grad_norm, rel=1e-5)


def test_delta_cloud_falls_back_with_its_reason_and_the_superround_numbers():
    (jr, js), (tr, ts), np_params = _run_both(["run.engine=megakernel", "schedule.delta_cloud=true"])
    eng = tr._engine
    assert not eng.uses_megakernel and "delta_cloud" in eng.megakernel_reason
    assert eng.megakernel_reason == jr._engine.megakernel_reason == tr._megakernel_reason
    spec = tapi.ExperimentSpec.parse(SPEC + ["run.engine=superround", "schedule.delta_cloud=true"])
    sr, ss = spec.run_experiment(device="cpu", params=spec.params_from_numpy(np_params, "cpu"))
    for k in ts.params:
        assert torch.equal(ts.params[k], ss.params[k])
    assert [h.loss for h in tr.history] == [h.loss for h in sr.history]
    assert_close(to_numpy(ts.params), jax.device_get(js.params), rtol=0.0, atol=1e-4, what="final params")


def test_runner_config_engine_validation():
    trunner.RunnerConfig(num_rounds=1, engine="megakernel")
    with pytest.raises(ValueError, match="megakernel"):
        trunner.RunnerConfig(num_rounds=1, engine="hyperkernel")


def test_megakernel_raises_without_a_whole_interval():
    spec = tapi.ExperimentSpec.parse(SPEC + ["run.engine=megakernel", "run.num_rounds=1"])
    with pytest.raises(ValueError, match="megakernel"):
        spec.run_experiment(device="cpu")
