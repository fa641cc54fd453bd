"""The paper's CNNs in the port against the JAX package's
(``repro/models/cnn.py``): the layout helpers, both models' logits, losses
and gradients from the JAX init carried across, the parameter counts, one
cloud interval of the MNIST CNN through ``build_super_round``, and a control
that flattens in NCHW order and must fail the tolerance.

Tolerance ``rtol=1e-4, atol=1e-5`` (the LM tolerance of
``test_torch_hierfavg.py``): XLA's and PyTorch's convolutions sum their
25-1152 products in different orders, which parts logits of order 1-10 by
up to 3e-6 and the super round's params by up to 5e-6."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import hierfavg as jh
from repro.models import cnn as jc
from repro import optim as joptim
from repro_torch import models as tm
from repro_torch.core import hierfavg as th
from repro_torch.data import synthetic as tsynth
from repro_torch.models import cnn as tc
from repro_torch import optim as toptim
from repro_torch.testing.parity import assert_close, to_numpy

TOL = dict(rtol=1e-4, atol=1e-5)
MODELS = {
    "mnist": (jc.init_mnist_cnn, jc.mnist_cnn_apply, tc.mnist_cnn_apply, (28, 28, 1), 21_840),
    "cifar": (jc.init_cifar_cnn, jc.cifar_cnn_apply, tc.cifar_cnn_apply, (32, 32, 3), 5_537_578),
}


def _jax_init(name, seed=0):
    init = MODELS[name][0]
    return jax.device_get(init(jax.random.PRNGKey(seed)))


def _images(rng, lead, shape):
    return rng.normal(size=lead + shape).astype(np.float32)


@pytest.mark.parametrize("shape,kernel", [((2, 9, 9, 3), (5, 5, 3, 4)), ((2, 8, 8, 3), (3, 3, 3, 5)),
                                          ((1, 7, 6, 2), (3, 3, 2, 2)), ((1, 7, 8, 2), (3, 5, 2, 3))])
def test_conv_and_pool_helpers_match_jax(shape, kernel):
    rng = np.random.default_rng(sum(shape))
    x, w, b = _images(rng, (), shape), _images(rng, (), kernel), _images(rng, (), kernel[-1:])
    tx, tw, tb = (torch.from_numpy(a) for a in (x, w, b))
    assert_close(tc.conv2d(tx, tw, tb).numpy(), np.asarray(jc.conv2d(x, w, b)), what="VALID", **TOL)
    assert_close(tc.conv2d_same(tx, tw, tb).numpy(), np.asarray(jc.conv2d_same(x, w, b)), what="SAME",
                 **TOL)
    np.testing.assert_array_equal(tc.maxpool2(tx).numpy(), np.asarray(jc.maxpool2(x)))


@pytest.mark.parametrize("name", sorted(MODELS))
def test_parameter_counts_names_and_init_scale(name):
    count = MODELS[name][4]
    jparams = _jax_init(name)
    init = tc.init_mnist_cnn if name == "mnist" else tc.init_cifar_cnn
    tparams = init(torch.Generator().manual_seed(0))
    assert jc.count_params(jparams) == tc.count_params(tparams) == count
    assert {k: tuple(v.shape) for k, v in tparams.items()} == {k: tuple(v.shape) for k, v in jparams.items()}
    for k, v in tparams.items():
        if k.endswith("b"):
            assert not v.any(), k
        else:  # N(0, 2 / fan_in): fan_in the product of all but the output dim
            std = (2.0 / np.prod(v.shape[:-1])) ** 0.5
            assert abs(float(v.std()) / std - 1) < 0.35, k
    module = tc.MnistCNN() if name == "mnist" else tc.CifarCNN()
    assert sorted(dict(module.named_parameters())) == sorted(jparams)


@pytest.mark.parametrize("name", sorted(MODELS))
def test_logits_losses_and_grads_match_jax(name):
    _, japply, tapply, shape, _ = MODELS[name]
    jparams = _jax_init(name, seed=3)
    rng = np.random.default_rng(7)
    x = _images(rng, (6,), shape)
    y = rng.integers(0, 10, size=6).astype(np.int32)
    tparams = tm.params_from_numpy(jparams, "cpu")
    assert_close(tapply(tparams, torch.from_numpy(x)).numpy(), np.asarray(japply(jparams, x)),
                 what=f"{name} logits", **TOL)
    module = tc.MnistCNN() if name == "mnist" else tc.CifarCNN()
    module.load_state_dict(tparams)
    assert_close(module(torch.from_numpy(x)).detach().numpy(), np.asarray(japply(jparams, x)),
                 what=f"{name} module logits", **TOL)

    jloss_fn, tloss_fn = jc.make_cnn_loss_fn(japply), tc.make_cnn_loss_fn(tapply)
    batch = {"inputs": x, "targets": y}
    jloss, jgrads = jax.value_and_grad(jloss_fn)(jparams, batch, None)
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    tgrads, tloss = torch.func.grad_and_value(tloss_fn)(tparams, tbatch, None)
    assert_close(float(tloss), float(jloss), what=f"{name} loss", **TOL)
    assert_close(to_numpy(tgrads), jax.device_get(jgrads), what=f"{name} grads", **TOL)


def _mnist_apply_flattening_nchw(params, x):
    """The MNIST CNN with the dense layer's rows taken in NCHW order."""
    h = x.permute(0, 3, 1, 2)
    h = torch.relu(tc._pool_nchw(tc._conv_nchw(h, params["c1w"], params["c1b"], 0)))
    h = torch.relu(tc._pool_nchw(tc._conv_nchw(h, params["c2w"], params["c2b"], 0)))
    h = torch.relu(h.reshape(h.shape[0], -1) @ params["f1w"] + params["f1b"])
    return h @ params["f2w"] + params["f2b"]


def test_flattening_in_nchw_order_fails_the_tolerance():
    jparams = _jax_init("mnist", seed=5)
    x = _images(np.random.default_rng(5), (8,), (28, 28, 1))
    want = np.asarray(jc.mnist_cnn_apply(jparams, x))
    tparams = tm.params_from_numpy(jparams, "cpu")
    got = tc.mnist_cnn_apply(tparams, torch.from_numpy(x)).numpy()
    wrong = _mnist_apply_flattening_nchw(tparams, torch.from_numpy(x)).numpy()
    assert_close(got, want, what="NHWC flatten", **TOL)
    excess = np.abs(wrong - want) - (TOL["atol"] + TOL["rtol"] * np.abs(want))
    assert excess.max() > 100 * TOL["atol"], excess.max()
    with pytest.raises(AssertionError):
        assert_close(wrong, want, what="NCHW flatten", **TOL)


@pytest.mark.parametrize("masked", [False, True], ids=["all_alive", "masked"])
def test_mnist_super_round_matches_jax(masked):
    """4 clients on 2 edges, kappa (2, 2), two cloud intervals of the paper's
    SGD with exponential decay, from the JAX init."""
    jparams = _jax_init("mnist", seed=1)
    tparams = tm.params_from_numpy(jparams, "cpu")
    jtopo, ttopo = jh.FedTopology(num_edges=2, clients_per_edge=2), th.FedTopology(num_edges=2, clients_per_edge=2)
    jcfg, tcfg = jh.HierFAVGConfig(kappa1=2, kappa2=2), th.HierFAVGConfig(kappa1=2, kappa2=2)
    jopt = joptim.sgd(joptim.exponential_decay(0.1, 0.992, 4))
    topt = toptim.sgd(toptim.exponential_decay(0.1, 0.992, 4))
    js = jh.init_state(jax.random.PRNGKey(0), jax.tree_util.tree_map(jnp.asarray, jparams), jopt, jtopo, jcfg)
    ts = th.init_state(torch.Generator().manual_seed(0), tparams, topt, ttopo, tcfg)
    rng = np.random.default_rng(11)
    weights = rng.integers(20, 80, 4).astype(np.float32)
    jsuper = jax.jit(jh.build_super_round(jc.make_cnn_loss_fn(jc.mnist_cnn_apply), jopt, jtopo, jcfg,
                                         jnp.asarray(weights)))
    tsuper = th.build_super_round(tc.make_cnn_loss_fn(tc.mnist_cnn_apply), topt, ttopo, tcfg,
                                  torch.from_numpy(weights))
    for _ in range(2):
        block = {"inputs": _images(rng, (2, 2, 4, 5), (28, 28, 1)),
                 "targets": rng.integers(0, 10, size=(2, 2, 4, 5)).astype(np.int32)}
        masks = None
        if masked:
            masks = np.array([[1, 0, 0, 0], [1, 1, 0, 1]], np.float32)  # edge 1 dead in the first round
        js, jm = jsuper(js, {k: jnp.asarray(v) for k, v in block.items()},
                        None if masks is None else jnp.asarray(masks))
        ts, tmet = tsuper(ts, {k: torch.from_numpy(v) for k, v in block.items()},
                          None if masks is None else torch.from_numpy(masks))
        assert_close(to_numpy(tmet), jax.device_get(jm), what="metrics", **TOL)
    assert int(ts.step) == int(js.step) == 8
    assert_close(to_numpy(ts.params), jax.device_get(js.params), what="params after two intervals", **TOL)


# the stand-in's scales: clustered_gaussians' default (centres 3.0, noise
# 1.0), and chip_smoke.py's PAPER_DATA_SCALE (0.1, 0.1)
STAND_IN = {"default_scale": {}, "chip_scale": dict(class_sep=0.1, noise=0.1)}


@pytest.mark.parametrize("scale", sorted(STAND_IN))
def test_cifar_sgd_on_the_stand_in_images_matches_jax(scale):
    """Four steps of the paper's SGD (lr 0.1, batches of 20) on the CIFAR
    CNN from the JAX init, on the synthetic stand-in of CIFAR-10's images,
    each package on its own trajectory: at the generator's default scale
    both overflow within four steps, which is why the card's
    ``paper_cifar10`` draws its images at centres and noise 0.1, where both
    stay finite. The port's loss at each finite point of JAX's trajectory
    is JAX's within ``TOL`` (the two trajectories themselves part after a
    large step, as any two summation orders do)."""
    data = tsynth.clustered_gaussians(np.random.default_rng(0), num_samples=80, dim=(32, 32, 3),
                                      **STAND_IN[scale])
    jparams = _jax_init("cifar", seed=2)
    tparams = tm.params_from_numpy(jparams, "cpu")
    jstep = jax.jit(jax.value_and_grad(jc.make_cnn_loss_fn(jc.cifar_cnn_apply)))
    tstep = torch.func.grad_and_value(tc.make_cnn_loss_fn(tc.cifar_cnn_apply))
    jlosses, tlosses, at_jax = [], [], []
    for i in range(0, 80, 20):
        batch = {"inputs": data.x[i:i + 20], "targets": data.y[i:i + 20]}
        tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
        jloss, jgrads = jstep(jparams, batch, None)
        at_jax.append(float(tstep(tm.params_from_numpy(jax.device_get(jparams), "cpu"), tbatch, None)[1]))
        tgrads, tloss = tstep(tparams, tbatch, None)
        jparams = jax.tree_util.tree_map(lambda p, g: p - 0.1 * g, jparams, jgrads)
        tparams = {k: v - 0.1 * tgrads[k] for k, v in tparams.items()}
        jlosses.append(float(jloss))
        tlosses.append(float(tloss))
    finite = np.isfinite(jlosses)
    np.testing.assert_array_equal(np.isfinite(at_jax), finite)
    assert_close(np.array(at_jax)[finite], np.array(jlosses)[finite], what=f"{scale} losses", **TOL)
    assert tlosses[0] == at_jax[0]
    if scale == "default_scale":
        assert not np.isfinite(jlosses[-1]) and not np.isfinite(tlosses[-1]), (jlosses, tlosses)
        assert max(np.array(jlosses)[finite]) > 1e6, jlosses
    else:
        assert np.isfinite(jlosses).all() and np.isfinite(tlosses).all(), (jlosses, tlosses)
