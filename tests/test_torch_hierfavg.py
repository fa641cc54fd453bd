"""The port's HierFAVG step functions against the JAX package's: one local step
(losses, gradients, metrics, updated parameters) and whole cloud intervals
of ``build_super_round`` for several kappa vectors, a ragged tree, a
depth-3 tree, and survival masks handed straight to the syncs.

Both packages start from the same parameters (the JAX init carried across
with ``params_from_numpy``) and see the same numpy batches. Tolerance:
``rtol=1e-5`` (``atol=1e-6`` for parameters near zero): f32 matmuls and
reductions summed in another order drift by a few ulp per step, over a few
dozen steps.

The LM case (``test_cloud_intervals_on_lm_trees_match_jax``: smoke LMs'
nested, stacked trees with Adam) is held to ``LM_TOL`` instead, the
tolerance of ``tests/test_torch_lm_train.py``'s scenario (measured:
grad_norm within 2e-5, parameters within 6.1e-6 at lr 3e-2, against moves
of about 0.1). The MLP's ``rtol=1e-5`` does not hold there: Adam divides
by ``sqrt(nu)``, so a coordinate whose gradient is near zero moves by
about lr whatever its size, and rounding decides its sign. Its int8 case
runs at lr 3e-3: jitted XLA computes a block's scale as a multiply by the
reciprocal of 127, one ulp off the port's division (ROADMAP.md Queue 3),
so a code can round the other way and move its delta by a whole code step
(absmax / 127); at lr 3e-2 such steps reach 1.9e-4 in the parameters. The
error-feedback residual is held leaf by leaf to ``LM_TOL`` in all but one
value in a thousand, and those within one code step (twice the largest
|residual|).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jreg
from repro.core import hierfavg as jh
from repro.core.hierarchy import parse_fanouts as jparse
from repro.fed import api as japi
from repro.fed import transport as jtransport
from repro.models import transformer as jt
from repro import optim as joptim
from repro_torch import models as tmodels
from repro_torch.configs import registry as treg
from repro_torch.core import hierfavg as th
from repro_torch.core.hierarchy import parse_fanouts as tparse
from repro_torch.fed import api as tapi
from repro_torch.fed import transport as ttransport
from repro_torch.models import transformer as tt
from repro_torch import optim as toptim
from repro_torch.testing.parity import assert_close, to_numpy
from repro_torch.tree import leaves

TOL = dict(rtol=1e-5, atol=1e-6)
LM_TOL = dict(rtol=1e-4, atol=1e-5)
DIM, HIDDEN, CLASSES, BATCH = 6, 8, 4, 3
MODEL = [f"data.dim={DIM}", f"model.hidden={HIDDEN}", f"data.num_classes={CLASSES}"]


def _models():
    jspec = japi.ExperimentSpec.parse(MODEL)
    tspec = tapi.ExperimentSpec.parse(MODEL)
    np_params = jax.device_get(jspec.init_params(jax.random.PRNGKey(1)))
    return (
        japi._model_bundle(jspec), jax.tree_util.tree_map(jnp.asarray, np_params),
        tspec.model_bundle("cpu"), tspec.params_from_numpy(np_params, "cpu"),
    )


def _batch(rng, lead):
    return {
        "inputs": rng.normal(size=lead + (BATCH, DIM)).astype(np.float32),
        "targets": rng.integers(0, CLASSES, size=lead + (BATCH,)).astype(np.int32),
    }


def _opts(kind="sgd"):
    if kind == "adam":
        return joptim.adam(0.01), toptim.adam(0.01)
    return (
        joptim.sgd(joptim.exponential_decay(0.15, 0.9, 3)),
        toptim.sgd(toptim.exponential_decay(0.15, 0.9, 3)),
    )


def _states(tree, kappas, jparams, tparams, jopt, topt, **cfg):
    jspec, tspec = jparse(tree), tparse(tree)
    jcfg = jh.HierFAVGConfig.multi_level(kappas, **cfg)
    tcfg = th.HierFAVGConfig.multi_level(kappas, **cfg)
    js = jh.init_state(jax.random.PRNGKey(0), jparams, jopt, jspec, jcfg)
    ts = th.init_state(torch.Generator().manual_seed(0), tparams, topt, tspec, tcfg)
    return (jspec, jcfg, js), (tspec, tcfg, ts)


def test_one_local_step_losses_grads_and_update():
    jb, jparams, tb, tparams = _models()
    rng = np.random.default_rng(0)
    n = 20
    batch = _batch(rng, (n,))
    jopt, topt = _opts()
    (_, _, js), (_, _, ts) = _states("5,5,5,5/4", (2, 2), jparams, tparams, jopt, topt)

    # per-client losses and gradients of the summed loss
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    rngs = jax.random.split(jax.random.PRNGKey(3), n)
    jtotal = lambda p: (lambda l: (jnp.sum(l), l))(jax.vmap(jb["loss"])(p, jbatch, rngs))
    jgrads, jlosses = jax.grad(jtotal, has_aux=True)(js.params)
    ttotal = lambda p: (lambda l: (torch.sum(l), l))(torch.func.vmap(tb["loss"], in_dims=(0, 0, None))(p, tbatch, None))
    tgrads, tlosses = torch.func.grad(ttotal, has_aux=True)(ts.params)
    assert_close(to_numpy(tlosses), np.asarray(jlosses), what="per-client losses", **TOL)
    assert_close(to_numpy(tgrads), jax.device_get(jgrads), what="per-client grads", **TOL)

    jnew, jm = jax.jit(jh.build_local_step(jb["loss"], jopt))(js, jbatch)
    tnew, tm = th.build_local_step(tb["loss"], topt)(ts, tbatch)
    assert int(tnew.step) == int(jnew.step) == 1
    assert_close(to_numpy(tm), jax.device_get(jm), what="local-step metrics", **TOL)
    assert_close(to_numpy(tnew.params), jax.device_get(jnew.params), what="params after one step", **TOL)
    assert int(tnew.opt_state.count) == int(jnew.opt_state.count) == 1


def _run_intervals(tree, kappas, masked, opt="sgd", intervals=2, **cfg):
    jb, jparams, tb, tparams = _models()
    jopt, topt = _opts(opt)
    (jspec, jcfg, js), (tspec, tcfg, ts) = _states(tree, kappas, jparams, tparams, jopt, topt, **cfg)
    rng = np.random.default_rng(len(tree) * 7 + sum(kappas))
    n = jspec.num_clients
    weights = rng.integers(20, 80, n).astype(np.float32)
    jsuper = jax.jit(jh.build_super_round(jb["loss"], jopt, jspec, jcfg, jnp.asarray(weights)))
    tsuper = th.build_super_round(tb["loss"], topt, tspec, tcfg, torch.from_numpy(weights))
    k2 = jcfg.kappa2_effective
    for _ in range(intervals):
        block = _batch(rng, (k2, jcfg.kappa1, n))
        masks = None
        if masked:
            masks = (rng.random((k2, n)) > 0.25).astype(np.float32)
            masks[0, tspec.segments(1) == 0] = 0.0  # edge 0 dead in the first round
        js, jm = jsuper(js, {k: jnp.asarray(v) for k, v in block.items()},
                        None if masks is None else jnp.asarray(masks))
        ts, tm = tsuper(ts, {k: torch.from_numpy(v) for k, v in block.items()},
                        None if masks is None else torch.from_numpy(masks))
        assert_close(to_numpy(tm), jax.device_get(jm), what=f"metrics {kappas}", **TOL)
    assert int(ts.step) == int(js.step) == intervals * jcfg.cloud_interval
    assert_close(to_numpy(ts.params), jax.device_get(js.params), what=f"params {tree} {kappas}", **TOL)
    return js, ts


@pytest.mark.parametrize("kappas", [(2, 3), (1, 1), (3, 1), (1, 4)])
@pytest.mark.parametrize("masked", [False, True], ids=["all_alive", "masked"])
def test_cloud_intervals_match_uniform_tree(kappas, masked):
    _run_intervals("5,5,5,5/4", kappas, masked)


@pytest.mark.parametrize("masked", [False, True], ids=["all_alive", "masked"])
def test_cloud_intervals_match_ragged_tree(masked):
    _run_intervals("16,12,10,7,5/5", (2, 3), masked)


@pytest.mark.parametrize("masked", [False, True], ids=["all_alive", "masked"])
def test_cloud_intervals_match_depth3_tree(masked):
    _run_intervals("10,10,10,10,10/3,2/2", (1, 2, 2), masked)


def test_sync_opt_state_with_adam_matches():
    js, ts = _run_intervals("5,5,5,5/4", (2, 2), False, opt="adam", intervals=1, sync_opt_state=True)
    jadam, tadam = js.opt_state[0], ts.opt_state[0]
    assert_close(to_numpy(tadam.mu), jax.device_get(jadam.mu), what="adam mu", **TOL)
    assert_close(to_numpy(tadam.nu), jax.device_get(jadam.nu), rtol=1e-5, atol=1e-9, what="adam nu")


def test_hier_round_driven_kappa2_times_equals_super_round():
    _, _, tb, tparams = _models()
    _, topt = _opts()
    tspec = tparse("16,12,10,7,5/5")
    cfg = th.HierFAVGConfig.multi_level((2, 3))
    rng = np.random.default_rng(4)
    w = torch.from_numpy(rng.integers(20, 80, 50).astype(np.float32))
    block = {k: torch.from_numpy(v) for k, v in _batch(rng, (3, 2, 50)).items()}
    a = th.init_state(torch.Generator().manual_seed(0), tparams, topt, tspec, cfg)
    b = th.init_state(torch.Generator().manual_seed(0), tparams, topt, tspec, cfg)
    a, ma = th.build_super_round(tb["loss"], topt, tspec, cfg, w)(a, block)
    hier_round = th.build_hier_round(tb["loss"], topt, tspec, cfg, w)
    losses = []
    for r in range(3):
        b, m = hier_round(b, {k: v[r] for k, v in block.items()}, r)
        losses.append(m["loss"])
    assert torch.equal(ma["loss"], torch.stack(losses))
    for k in a.params:
        assert torch.equal(a.params[k], b.params[k])


@pytest.mark.parametrize("kappas", [(4, 2), (6, 10), (6, 5, 2), (60, 1), (3,), (2, 3, 4)])
def test_config_and_schedule_match(kappas):
    jc, tc = jh.HierFAVGConfig.multi_level(kappas), th.HierFAVGConfig.multi_level(kappas)
    assert th.super_round_schedule(tc) == jh.super_round_schedule(jc)
    for attr in ("kappa1", "kappa2", "kappa_vector", "num_levels", "cloud_interval", "kappa2_effective"):
        assert getattr(tc, attr) == getattr(jc, attr), attr
    assert [tc.level_interval(l) for l in range(1, tc.num_levels + 1)] == [
        jc.level_interval(l) for l in range(1, jc.num_levels + 1)
    ]
    assert not (tc.transport_active or tc.aggregators_active or tc.participation_active or tc.precision_active)


def test_config_validation():
    with pytest.raises(ValueError, match="inconsistent"):
        th.HierFAVGConfig(kappa1=2, kappa2=3, kappas=(2, 4))
    with pytest.raises(ValueError, match=">= 1"):
        th.HierFAVGConfig.multi_level((2, 0))
    with pytest.raises(ValueError, match="depth"):
        th.build_super_round(None, toptim.sgd(0.1), tparse("2,2/2"), th.HierFAVGConfig.multi_level((1, 1, 1)),
                             torch.ones(4))
    cfg = th.HierFAVGConfig.multi_level((2, 2), precision=th.PrecisionSpec(remat=True))
    assert cfg.precision_active and cfg.precision.dtype == torch.float32
    assert th.PrecisionSpec(param_dtype="float").param_dtype == "float64"  # numpy's name rules, as jnp.dtype
    with pytest.raises(ValueError, match="floating"):
        th.PrecisionSpec(param_dtype="int32")


def test_replicate_and_init_state():
    _, _, _, tparams = _models()
    stacked = th.replicate_for_clients(tparams, 5)
    for k, v in stacked.items():
        assert v.shape == (5,) + tparams[k].shape and v.is_contiguous()
        assert torch.equal(v[3], tparams[k])
    s = th.init_state(torch.Generator(), tparams, toptim.sgd(0.1), th.FedTopology(2, 3),
                      th.HierFAVGConfig.multi_level((1, 1)))
    assert s.step.dtype == torch.int32 and int(s.step) == 0
    assert s.params["w1"].shape[0] == 6


def _lm_models(arch, **changes):
    jcfg, tcfg = jreg.get_smoke(arch), treg.get_smoke(arch)
    if changes:
        jcfg, tcfg = dataclasses.replace(jcfg, **changes), dataclasses.replace(tcfg, **changes)
    jp = jt.init_params(jax.random.PRNGKey(0), jcfg)
    like = tt.init_params(torch.Generator().manual_seed(0), tcfg)
    return jcfg, tcfg, jp, tmodels.params_from_numpy(jax.device_get(jp), "cpu", like=like)


@pytest.mark.parametrize("arch,changes,transport,lr", [
    ("internvl2-2b", {}, "int8_ef:128/int8_ef:128", 3e-3),
    ("granite-3-2b", {"scan_layers": False}, None, 3e-2),
], ids=["internvl2_embeddings_int8_ef", "granite_blocks_unrolled"])
def test_cloud_intervals_on_lm_trees_match_jax(arch, changes, transport, lr):
    """Two cloud intervals of ``build_super_round`` (kappa (2, 2), 2 x 2
    clients) on a smoke LM with Adam, warmup-cosine and ``sync_opt_state``,
    survival masks with a dead edge, and (first case: a stub-frontend model
    fed f32 embeddings) error-feedback int8 on both hops; the second case's
    tree holds the ``blocks_unrolled`` list."""
    jcfg, tcfg, jparams, tparams = _lm_models(arch, **changes)
    kw = dict(sync_opt_state=True)
    jkw, tkw = dict(kw), dict(kw)
    if transport:
        jkw["transport"] = jtransport.TransportSpec.parse(transport)
        tkw["transport"] = ttransport.TransportSpec.parse(transport)
    jcfg_h, tcfg_h = jh.HierFAVGConfig.multi_level((2, 2), **jkw), th.HierFAVGConfig.multi_level((2, 2), **tkw)
    jspec, tspec = jparse("2,2/2"), tparse("2,2/2")
    jopt, topt = joptim.adam(joptim.warmup_cosine(lr, 2, 8)), toptim.adam(toptim.warmup_cosine(lr, 2, 8))
    js = jh.init_state(jax.random.PRNGKey(0), jparams, jopt, jspec, jcfg_h)
    ts = th.init_state(torch.Generator().manual_seed(0), tparams, topt, tspec, tcfg_h)
    rng = np.random.default_rng(11)
    weights = rng.integers(20, 80, 4).astype(np.float32)
    jsuper = jax.jit(jh.build_super_round(jt.make_loss_fn(jcfg), jopt, jspec, jcfg_h, jnp.asarray(weights)))
    tsuper = th.build_super_round(tt.make_loss_fn(tcfg), topt, tspec, tcfg_h, torch.from_numpy(weights))
    for interval in range(2):
        lead = (2, 2, 4, 2)  # (kappa2, kappa1, N, b)
        if tcfg.embed_inputs:
            x = rng.integers(0, tcfg.vocab_size, size=lead + (8,)).astype(np.int32)
        else:
            x = rng.normal(size=lead + (8, tcfg.d_model)).astype(np.float32)
        block = {"inputs": x, "targets": rng.integers(0, tcfg.vocab_size, size=lead + (8,)).astype(np.int32)}
        masks = (rng.random((2, 4)) > 0.3).astype(np.float32)
        if interval == 0:
            masks[0, :2] = 0.0  # edge 0 dead in the first round
        js, jm = jsuper(js, {k: jnp.asarray(v) for k, v in block.items()}, jnp.asarray(masks))
        ts, tm = tsuper(ts, {k: torch.from_numpy(v) for k, v in block.items()}, torch.from_numpy(masks))
        assert_close(to_numpy(tm), jax.device_get(jm), what=f"{arch} metrics", **LM_TOL)
    assert int(ts.step) == int(js.step) == 8
    assert_close(to_numpy(ts.params), jax.device_get(js.params), what=f"{arch} params", **LM_TOL)
    jadam, tadam = js.opt_state[0], ts.opt_state[0]
    assert_close(to_numpy(tadam.mu), jax.device_get(jadam.mu), what=f"{arch} adam mu", **LM_TOL)
    assert_close(to_numpy(tadam.nu), jax.device_get(jadam.nu), rtol=1e-5, atol=1e-9, what=f"{arch} adam nu")
    if transport:  # a code rounded the other way moves its residual by one code step
        for got, want in zip(leaves(to_numpy(ts.residual)), leaves(jax.device_get(js.residual))):
            err = np.abs(got - np.asarray(want))
            off = err > LM_TOL["atol"] + LM_TOL["rtol"] * np.abs(want)
            assert off.sum() <= max(1, 1e-3 * off.size), f"{arch} residual: {off.sum()} of {off.size} off"
            assert err.max() <= 2 * np.abs(want).max(), f"{arch} residual: {err.max()} beyond a code step"
