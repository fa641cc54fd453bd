"""The port's analysis modules against the JAX package's: the convergence
bounds and guidelines (``core/convergence.py``: the laws of
``tests/test_convergence.py`` on the port, and equality on a grid), the
divergence probes (``core/divergence.py``, at the MNIST CNN's size), the
literal Algorithm 1 (``core/reference.py``) and the port's engine held to
it on quadratics (as ``tests/test_hierfavg.py:28-58`` holds JAX's), and
the roofline (``analysis/roofline.py``): its arithmetic, the K3 cost model,
``model_flops`` for every registered arch, and the calibration on the CPU.

Tolerances: the convergence functions and the roofline arithmetic are the
same float64 ``math`` in both packages, so they are held equal; the
divergences are f32 sums of f32 gradients in both, held to ``rtol=1e-4``;
the engine holds the numpy oracle to ``atol=1e-5``, as JAX's test does."""
import math
import re
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.analysis import hlo as jhlo
from repro.analysis import roofline as jr
from repro.configs import registry as jreg
from repro.configs.base import LM_SHAPES as JSHAPES
from repro.core import convergence as jcv
from repro.core import divergence as jdiv
from repro.core import reference as jref
from repro.models import cnn as jc
from repro.sim import calibrate as jcal
from repro_torch import models as tm
from repro_torch.analysis import roofline as tr
from repro_torch.configs import registry as treg
from repro_torch.configs.base import LM_SHAPES as TSHAPES
from repro_torch.core import FedTopology, HierFAVGConfig, build_train_step, init_state
from repro_torch.core import convergence as tcv
from repro_torch.core import divergence as tdiv
from repro_torch.core import reference as tref
from repro_torch.models import cnn as tc
from repro_torch.optim import sgd
from repro_torch.sim import calibrate as tcal
from repro_torch.testing import given, settings, st
from repro_torch.tree import leaves

DIV_TOL = dict(rtol=1e-4)
# a while loop of 5 trips over a dot and an all-reduce (``tests/test_analysis.py``'s module)
HLO_SAMPLE = """\
HloModule test

%add (a: f32[], b: f32[]) -> f32[] {
  %a = f32[] parameter(0)
  %b = f32[] parameter(1)
  ROOT %s = f32[] add(%a, %b)
}

%body (p: (s32[], f32[8,16])) -> (s32[], f32[8,16]) {
  %p = (s32[], f32[8,16]) parameter(0)
  %i = s32[] get-tuple-element(%p), index=0
  %x = f32[8,16]{1,0} get-tuple-element(%p), index=1
  %w = f32[16,16]{1,0} constant({...})
  %d = f32[8,16]{1,0} dot(%x, %w), lhs_contracting_dims={1}, rhs_contracting_dims={0}
  %ar = f32[8,16]{1,0} all-reduce(%d), channel_id=1, replica_groups=[4,2]<=[8], use_global_device_ids=true, to_apply=%add
  %one = s32[] constant(1)
  %ni = s32[] add(%i, %one)
  ROOT %t = (s32[], f32[8,16]) tuple(%ni, %ar)
}

%cond (p: (s32[], f32[8,16])) -> pred[] {
  %p = (s32[], f32[8,16]) parameter(0)
  %i = s32[] get-tuple-element(%p), index=0
  %k = s32[] constant(5)
  ROOT %c = pred[] compare(%i, %k), direction=LT
}

ENTRY %main (x: f32[8,16]) -> (s32[], f32[8,16]) {
  %x = f32[8,16]{1,0} parameter(0)
  %z = s32[] constant(0)
  %init = (s32[], f32[8,16]) tuple(%z, %x)
  ROOT %w = (s32[], f32[8,16]) while(%init), condition=%cond, body=%body
}
"""

ETA = st.floats(1e-4, 0.5)
BETA = st.floats(0.1, 10.0)
DELTA = st.floats(0.0, 5.0)
KAPPA = st.integers(1, 16)


# -- convergence: JAX's laws on the port ------------------------------------------


@given(x=st.integers(0, 64), delta=DELTA, eta=ETA, beta=BETA)
def test_h_nonnegative_and_zero_at_zero_divergence(x, delta, eta, beta):
    assert tcv.h(x, 0.0, eta, beta) == pytest.approx(0.0)
    assert tcv.h(x, delta, eta, beta) >= -1e-9


@given(delta=DELTA, eta=ETA, beta=BETA, k1=KAPPA, k2=KAPPA)
def test_G_zero_iff_iid(delta, eta, beta, k1, k2):
    assert tcv.G_c_max(k1, k2, 0.0, 0.0, eta, beta) == pytest.approx(0.0)
    assert tcv.G_nc(k1, k2, 0.0, 0.0, eta, beta) == pytest.approx(0.0)
    if delta > 1e-6 and k1 * k2 > 1:
        assert tcv.G_c_max(k1, k2, delta, delta, eta, beta) > 0


@given(eta=ETA, beta=BETA, delta=st.floats(0.01, 5.0), Delta=st.floats(0.01, 5.0), k1=KAPPA, k2=KAPPA)
@settings(max_examples=60)
def test_G_monotone_in_kappas(eta, beta, delta, Delta, k1, k2):
    g = tcv.G_c_max(k1, k2, delta, Delta, eta, beta)
    assert tcv.G_c_max(k1 + 1, k2, delta, Delta, eta, beta) >= g - 1e-9
    assert tcv.G_c_max(k1, k2 + 1, delta, Delta, eta, beta) >= g - 1e-9


def test_kappa2_1_consistency():
    eta, beta, d, D, k1 = 0.01, 1.0, 0.5, 0.7, 6
    g = tcv.G_c(k1, k1, 1, d, D, eta, beta)
    two_layer = tcv.h(k1, D + d, eta, beta)
    assert g <= two_layer * 2 + 1e-9
    assert (g == 0) == (two_layer == 0)


def test_guidelines():
    out = tcv.guideline_smaller_kappa1(16, delta=0.5, Delta=0.5, eta=0.01, beta=1.0)
    gs = [g for _, _, g in out]
    assert [k1 for k1, _, _ in out] == [1, 2, 4, 8, 16]
    assert all(gs[i] <= gs[i + 1] + 1e-12 for i in range(len(gs) - 1))
    eta, beta, delta, k1 = 0.01, 1.0, 0.5, 4
    iid = tcv.guideline_edge_iid_kappa2_free(k1, delta, eta, beta, range(1, 30))
    niid = [tcv.G_c_max(k1, k2, delta, 0.5, eta, beta) for k2 in range(1, 30)]
    assert niid[-1] / niid[10] > iid[-1][1] / iid[10][1]


def test_theorem_bounds_tighten_with_K_and_go_infinite_when_infeasible():
    args = dict(kappa1=4, kappa2=2, delta=0.05, Delta=0.05, eta=0.01, beta=1.0, rho=1.0, epsilon=1.0, varphi=0.5)
    b1, b2 = tcv.theorem1_bound(K=64, **args), tcv.theorem1_bound(K=128, **args)
    assert 0 < b2 < b1 < math.inf
    assert tcv.theorem1_bound(K=64, kappa1=16, kappa2=16, delta=50.0, Delta=50.0, eta=0.4, beta=5.0,
                              rho=1.0, epsilon=0.01, varphi=0.01) == math.inf
    args2 = dict(kappa1=4, kappa2=2, delta=0.1, Delta=0.1, eta=0.01, beta=1.0, rho=1.0, f0_minus_fstar=10.0)
    assert tcv.theorem2_bound(K=256, **args2) < tcv.theorem2_bound(K=64, **args2)


GRID = [(k1, k2, d, D, eta, beta) for k1, k2 in ((1, 1), (5, 10), (10, 5), (15, 4), (60, 1))
        for d, D in ((0.0, 0.0), (0.3, 0.0), (0.3, 1.7)) for eta, beta in ((0.01, 1.0), (0.1, 4.0))]


@pytest.mark.parametrize("k1,k2,d,D,eta,beta", GRID)
def test_convergence_functions_equal_jax_on_a_grid(k1, k2, d, D, eta, beta):
    for x in (0, 1, k1, k1 * k2):
        assert tcv.h(x, d, eta, beta) == jcv.h(x, d, eta, beta)
    for k in range(1, 2 * k1 * k2 + 1, max(1, k1 * k2 // 7)):
        q = (k - 1) // (k1 * k2) + 1
        assert tcv.p_of_k(k, q, k1, k2) == jcv.p_of_k(k, q, k1, k2)
        assert tcv.G_c(k, k1, k2, d, D, eta, beta, q=q) == jcv.G_c(k, k1, k2, d, D, eta, beta, q=q)
    assert tcv.G_c_max(k1, k2, d, D, eta, beta) == jcv.G_c_max(k1, k2, d, D, eta, beta)
    assert tcv.G_nc(k1, k2, d, D, eta, beta) == jcv.G_nc(k1, k2, d, D, eta, beta)
    for K in (k1 * k2, 7 * k1 * k2):
        args = (K, k1, k2, d, D, eta, beta)
        assert tcv.theorem1_bound(*args, 1.0, 0.5, 0.3) == jcv.theorem1_bound(*args, 1.0, 0.5, 0.3)
        assert tcv.theorem2_bound(*args, 1.0, 2.5) == jcv.theorem2_bound(*args, 1.0, 2.5)
    assert tcv.guideline_smaller_kappa1(k1 * k2, d, D, eta, beta) == jcv.guideline_smaller_kappa1(
        k1 * k2, d, D, eta, beta)
    assert tcv.guideline_edge_iid_kappa2_free(k1, d, eta, beta, range(1, 12)) == \
        jcv.guideline_edge_iid_kappa2_free(k1, d, eta, beta, range(1, 12))


# -- divergence ----------------------------------------------------------------------


def _mnist_clients(n, per_client, seed):
    rng = np.random.default_rng(seed)
    xs = rng.normal(size=(n, per_client, 28, 28, 1)).astype(np.float32)
    ys = np.stack([rng.integers(0, 10, per_client) if i % 2 else np.full(per_client, i % 10)
                   for i in range(n)]).astype(np.int32)
    return xs, ys


@pytest.mark.parametrize("num_edges", [2, 1])
def test_measure_divergence_matches_jax_at_the_mnist_cnn(num_edges):
    """4 clients of 6 images (some single-class) at two probes: the init and
    a perturbed copy, client sizes unequal."""
    n = 4
    xs, ys = _mnist_clients(n, 6, seed=num_edges)
    sizes = np.array([6.0, 3.0, 5.0, 2.0])
    jp0 = jax.device_get(jc.init_mnist_cnn(jax.random.PRNGKey(2)))
    jp1 = jax.tree_util.tree_map(lambda a: a + 0.01 * np.sign(a), jp0)
    jloss = jc.make_cnn_loss_fn(jc.mnist_cnn_apply)
    jgrad = jax.jit(jax.grad(jloss))
    jgrad_fn = lambda w, i: jgrad(w, {"inputs": xs[i], "targets": ys[i]}, None)
    want = jdiv.measure_divergence(jgrad_fn, [jp0, jp1], sizes, num_edges)

    tloss = tc.make_cnn_loss_fn(tc.mnist_cnn_apply)
    tgrad = torch.func.grad(tloss)
    txs, tys = torch.from_numpy(xs), torch.from_numpy(ys)
    tgrad_fn = lambda w, i: tgrad(w, {"inputs": txs[i], "targets": tys[i]}, None)
    probes = [tm.params_from_numpy(p, "cpu") for p in (jp0, jp1)]
    got = tdiv.measure_divergence(tgrad_fn, probes, sizes, num_edges)
    assert sorted(got) == sorted(want)
    for key in ("delta_client_edge", "Delta_edge_cloud"):
        assert got[key].dtype == np.float64 and got[key].shape == want[key].shape
        np.testing.assert_allclose(got[key], want[key], **DIV_TOL, err_msg=key)
    assert got["delta"] == pytest.approx(want["delta"], rel=DIV_TOL["rtol"])
    assert got["Delta"] == pytest.approx(want["Delta"], rel=DIV_TOL["rtol"], abs=1e-12)
    assert got["delta"] > 0
    if num_edges == 1:
        assert got["Delta"] == 0.0  # one edge is the cloud


def test_measure_divergence_is_zero_for_identical_clients():
    g = {"w": torch.arange(6.0).reshape(2, 3)}
    out = tdiv.measure_divergence(lambda w, i: g, [None, None], np.ones(6), 3)
    assert out["delta"] == out["Delta"] == 0.0
    with pytest.raises(ValueError, match="divide evenly"):
        tdiv.measure_divergence(lambda w, i: g, [None], np.ones(5), 2)


@pytest.mark.parametrize("beta", [0.5, 3.0])
def test_beta_estimate_is_exact_on_an_isotropic_quadratic(beta):
    """F(w) = beta / 2 ||w||^2: g(w + e) - g(w) = beta e for every draw, so
    the estimate is beta (JAX's, from its own draws, too)."""
    w0 = {"a": torch.ones(5, 3), "b": torch.zeros(7)}
    grad = lambda w: {k: beta * v for k, v in w.items()}
    got = tdiv.estimate_beta_smoothness(grad, w0, torch.Generator().manual_seed(0), num_probes=4)
    assert got == pytest.approx(beta, rel=1e-5)
    jw0 = {k: jnp.asarray(v.numpy()) for k, v in w0.items()}
    jgot = jdiv.estimate_beta_smoothness(lambda w: jax.tree_util.tree_map(lambda v: beta * v, w), jw0,
                                         jax.random.PRNGKey(0), num_probes=4)
    assert got == pytest.approx(jgot, rel=1e-5)


def test_beta_estimate_lies_between_the_curvatures_of_a_diagonal_quadratic():
    diag = torch.linspace(0.5, 4.0, 64)
    got = tdiv.estimate_beta_smoothness(lambda w: {"w": diag * w["w"]}, {"w": torch.zeros(64)},
                                        torch.Generator().manual_seed(1), num_probes=8, radius=0.1)
    assert 0.5 <= got <= 4.0 * (1 + 1e-6)
    # the same generator state draws the same perturbations: the estimate repeats
    again = tdiv.estimate_beta_smoothness(lambda w: {"w": diag * w["w"]}, {"w": torch.zeros(64)},
                                          torch.Generator().manual_seed(1), num_probes=8, radius=0.1)
    assert again == got


# -- the literal Algorithm 1 and the port's engine -------------------------------------


def _quadratic(rng, n=6, dim=4):
    centers = rng.normal(size=(n, dim))
    sizes = rng.integers(1, 5, size=n).astype(np.float64)
    grad_fns = [lambda w, c=centers[i]: (w - c) for i in range(n)]
    loss_fn = lambda params, batch, _rng: 0.5 * torch.sum((params["w"] - batch["c"]) ** 2)
    return centers, sizes, grad_fns, loss_fn


@pytest.mark.parametrize("kappa1,kappa2", [(2, 3), (1, 1), (3, 1), (1, 4), (4, 2)])
def test_engine_matches_the_reference(kappa1, kappa2):
    rng = np.random.default_rng(0)
    n, dim, edges = 6, 4, 2
    centers, sizes, grad_fns, loss_fn = _quadratic(rng, n, dim)
    topo = FedTopology(num_edges=edges, clients_per_edge=n // edges)
    cfg = HierFAVGConfig(kappa1=kappa1, kappa2=kappa2)
    opt = sgd(0.1)
    state = init_state(torch.Generator().manual_seed(0), {"w": torch.zeros(dim)}, opt, topo, cfg)
    step = build_train_step(loss_fn, opt, topo, cfg, torch.tensor(sizes, dtype=torch.float32))
    batch = {"c": torch.tensor(centers, dtype=torch.float32)}
    K = 2 * kappa1 * kappa2 + kappa1  # includes a partial interval
    for _ in range(K):
        state, _ = step(state, batch)
    ref = tref.hierfavg_reference(np.zeros(dim), grad_fns, sizes, edges, kappa1, kappa2, K, 0.1)
    np.testing.assert_allclose(state.params["w"].numpy(), np.stack(ref), atol=1e-5)
    np.testing.assert_array_equal(np.stack(ref), np.stack(
        jref.hierfavg_reference(np.zeros(dim), grad_fns, sizes, edges, kappa1, kappa2, K, 0.1)))


def test_reference_remarks_and_equality_with_jax():
    """Remark 1: kappa2 = 1 is two-layer FAVG, kappa1 = kappa2 = 1 is
    centralized GD; a schedule as the learning rate; the port's oracle is
    JAX's bit for bit."""
    rng = np.random.default_rng(1)
    _, sizes, grad_fns, _ = _quadratic(rng, 6, 3)
    w0 = np.zeros(3)
    favg = tref.fedavg_reference(w0, grad_fns, sizes, 4, 12, 0.05)
    hier = tref.hierfavg_reference(w0, grad_fns, sizes, 2, 4, 1, 12, 0.05)
    np.testing.assert_allclose(np.stack(favg), np.stack(hier), atol=1e-12)
    cent = tref.centralized_gd_reference(w0, grad_fns, sizes, 10, 0.05)
    np.testing.assert_allclose(tref.hierfavg_reference(w0, grad_fns, sizes, 2, 1, 1, 10, 0.05)[0], cent, atol=1e-12)
    lr = lambda k: 0.1 * 0.9 ** k
    np.testing.assert_array_equal(np.stack(tref.hierfavg_reference(w0, grad_fns, sizes, 3, 2, 2, 9, lr)),
                                  np.stack(jref.hierfavg_reference(w0, grad_fns, sizes, 3, 2, 2, 9, lr)))
    np.testing.assert_array_equal(tref.centralized_gd_reference(w0, grad_fns, sizes, 7, lr),
                                  jref.centralized_gd_reference(w0, grad_fns, sizes, 7, lr))
    with pytest.raises(ValueError, match="divide evenly"):
        tref.hierfavg_reference(w0, grad_fns[:5], sizes[:5], 2, 1, 1, 1, 0.1)


# -- the roofline --------------------------------------------------------------------


def test_the_constants_are_the_h100_data_sheet():
    assert (tr.PEAK_FLOPS, tr.HBM_BW, tr.NVLINK_BW) == (67e12, 3.35e12, 450e9)
    assert tr.DCN_SLOWDOWN == jr.DCN_SLOWDOWN == 10.0
    t = tr.RooflineTerms("x", 1, 67e12, 3.35e12 * 2, 450e9 * 3, {"data": 450e9 * 3})
    assert (t.compute_s, t.memory_s, t.collective_s, t.dominant) == (1.0, 2.0, 3.0, "collective")


def _terms_pair(monkeypatch, *args, **kw):
    """The same terms in both packages, the port's priced at JAX's TPU
    constants: every derived figure must then be JAX's."""
    monkeypatch.setattr(tr, "PEAK_FLOPS", jr.PEAK_FLOPS)
    monkeypatch.setattr(tr, "HBM_BW", jr.HBM_BW)
    monkeypatch.setattr(tr, "NVLINK_BW", jr.ICI_BW)
    return jr.RooflineTerms(*args, **kw), tr.RooflineTerms(*args, **kw)


TERMS = [
    ("compute", 256, 197e12 * 0.5, 819e9 * 0.25, 50e9 * 0.1, {"model": 50e9 * 0.1}, 197e12 * 256 * 0.4),
    ("memory", 8, 1e12, 819e9 * 3, 1e9, {"data": 5e8, "pod,data": 5e8}, 1e12),
    ("collective", 4, 1e9, 1e9, 8e11, {"pod": 8e11}, 0.0),
    ("zero", 1, 0.0, 0.0, 0.0, {}, 0.0),
]


@pytest.mark.parametrize("args", TERMS, ids=[t[0] for t in TERMS])
def test_roofline_terms_arithmetic_is_jax_s(monkeypatch, args):
    j, t = _terms_pair(monkeypatch, *args)
    assert t.to_dict() == j.to_dict()
    assert t.bound_s == j.bound_s


def test_hierfavg_step_terms_arithmetic_is_jax_s(monkeypatch):
    jl, tl = _terms_pair(monkeypatch, "l", 256, 1e12, 1e9, 1e9, {"model": 1e9}, 3e14)
    je, te = _terms_pair(monkeypatch, "e", 256, 2e10, 4e9, 8e9, {"data": 8e9})
    jcl, tcl = _terms_pair(monkeypatch, "c", 256, 0, 0, 16e9, {"pod,data": 16e9})
    for k1, k2, edge, cloud in ((4, 2, True, True), (1, 1, True, False), (5, 10, False, True)):
        j = jr.hierfavg_step_terms("a", jl, je if edge else None, jcl if cloud else None, k1, k2)
        t = tr.hierfavg_step_terms("a", tl, te if edge else None, tcl if cloud else None, k1, k2)
        assert t.to_dict() == j.to_dict()
    assert t.coll_bytes_per_device == pytest.approx(1e9 + 16e9 / 50)


def test_from_summary_takes_jax_s_hlo_summary_and_feeds_the_simulator(monkeypatch):
    summary = jhlo.analyze(HLO_SAMPLE)
    j = jr.from_summary("s", summary, 8, model_flops_global=123.0)
    t = tr.from_summary("s", summary, 8, model_flops_global=123.0)
    for field in ("flops_per_device", "hbm_bytes_per_device", "coll_bytes_per_device", "coll_breakdown",
                  "model_flops_global", "chips"):
        assert getattr(t, field) == getattr(j, field), field
    duck = types.SimpleNamespace(flops=2.0, hbm_bytes=3.0, collective_bytes_per_device=lambda: 5.0,
                                 collective_breakdown=lambda: {"data": 5.0})
    assert tr.from_summary("d", duck, 1).coll_breakdown == {"data": 5.0}
    # sim.calibrate.from_roofline on the port's terms: JAX's costs from JAX's terms
    jl, tl = _terms_pair(monkeypatch, "l", 1, 1e12, 1e9, 0.0, {})
    je, te = _terms_pair(monkeypatch, "e", 1, 0, 0, 8e9, {"data": 8e9})
    jcl, tcl = _terms_pair(monkeypatch, "c", 1, 0, 0, 16e9, {"pod": 16e9})
    assert tcal.from_roofline(tl, te, tcl) == tcal.from_roofline(jl, je, jcl)
    assert tcal.from_roofline(tl, te, tcl).t_step == jcal.from_roofline(jl, je, jcl).t_step


@pytest.mark.parametrize("shape", [(8, 4, 2, 64, 128), (16, 4, 2, 64, 128), (32, 8, 1, 64, 1024),
                                   (50, 5, 20, 3072, 10)])
def test_megakernel_interval_cost_is_jax_s(shape):
    n, k1, b, f, o = shape
    for dtype_bytes in (4, 2):
        want = jr.megakernel_interval_cost(num_clients=n, kappa1=k1, batch=b, feat=f, out=o, dtype_bytes=dtype_bytes)
        got = tr.megakernel_interval_cost(num_clients=n, kappa1=k1, batch=b, feat=f, out=o, dtype_bytes=dtype_bytes)
        assert got == want
        no_mom = tr.megakernel_interval_cost(num_clients=n, kappa1=k1, batch=b, feat=f, out=o,
                                             dtype_bytes=dtype_bytes, momentum=False)
        assert no_mom["flops"] == want["flops"]
        assert want["bytes"] - no_mom["bytes"] == dtype_bytes * n * 2 * f * o


@pytest.mark.parametrize("arch", sorted(treg.ARCH_IDS) + ["lm-100m"])
def test_model_flops_is_jax_s_for_every_registered_arch(arch):
    jcfg, tcfg = jreg.get_config(arch), treg.get_config(arch)
    for js, ts in zip(JSHAPES, TSHAPES):
        assert (js.name, js.seq_len, js.global_batch, js.kind) == (ts.name, ts.seq_len, ts.global_batch, ts.kind)
        for active in (True, False):
            assert tr.model_flops(tcfg, ts, active=active) == jr.model_flops(jcfg, js, active=active)


@pytest.fixture
def one_thread():
    """The peaks and the calibrated interval on one intra-op thread: the
    suite's workers share the host's cores, and a product on all of them,
    descheduled among the workers, can be measured so slow that a
    fraction passes 1; best of 10 reps each."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_measured_peaks_and_calibration_on_the_cpu(one_thread):
    peaks = tr.measure_host_peaks(device="cpu", n=512, reps=10)
    assert peaks["flops"] > 0 and peaks["bw"] > 0
    for path in ("ref", "kernel"):  # on the CPU the kernel's entry point runs the plain version
        res = tr.calibrate_megakernel(reps=10, peaks=peaks, path=path, device="cpu")
        assert res.elapsed_s > 0 and res.name.startswith(f"edge_interval[{path}]")
        assert 0 < res.flops_fraction <= 1.05, res.to_dict()
        assert 0 < res.bw_fraction <= 1.05, res.to_dict()
        assert res.flops == jr.megakernel_interval_cost(num_clients=8, kappa1=4, batch=2, feat=64, out=128)["flops"]
        assert res.bytes_moved == tr.megakernel_interval_cost(num_clients=8, kappa1=4, batch=2, feat=64, out=128,
                                                              momentum=False)["bytes"]
    mom = tr.calibrate_megakernel(reps=1, peaks=peaks, momentum=0.9, device="cpu")
    assert mom.bytes_moved == jr.megakernel_interval_cost(num_clients=8, kappa1=4, batch=2, feat=64, out=128)["bytes"]
    with pytest.raises(ValueError, match=re.escape("path must be ref|kernel, got 'pallas'")):
        tr.calibrate_megakernel(path="pallas", peaks=peaks, device="cpu")
