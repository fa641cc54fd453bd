"""bf16 client state in the port (``PrecisionSpec.param_dtype``) against the
JAX package: the spec, the state's dtypes and bytes, leaf dtypes under
every engine, and the bf16 trajectory against JAX's bf16 run and against
the port's own f32 run.

Tolerances. bf16 against f32: JAX's own ``rtol=0.05, atol=0.01`` on the
per-round loss and 0.05 on accuracy (``tests/test_precision.py``). The
port's bf16 run against JAX's bf16 run: the two round bf16 at different
places (the CPU matmuls of the two frameworks accumulate and round
differently), so they sit about as far apart as bf16 sits from f32: the
largest per-round relative loss gap measured here is 2.3 % (megakernel)
and 1.6 % (superround, per-round), held to the same ``rtol=0.05,
atol=0.01``; accuracy within 0.01 (measured equal) and final params within
two bf16 ulp of 1 (``atol=1/64``; measured one ulp, 0.0039).
"""
import dataclasses
import json

import jax
import numpy as np
import pytest
import torch

from repro import optim as joptim
from repro.core import hierfavg as jh
from repro.fed import api as japi
from repro_torch import optim as toptim
from repro_torch.core import hierfavg as th
from repro_torch.fed import api as tapi
from repro_torch.testing.parity import assert_close, to_numpy

SPEC = ["topology.num_edges=2", "topology.clients_per_edge=4", "schedule.kappas=2,2", "data.num_samples=320",
        "data.batch_size=4", "run.num_rounds=8", "run.eval_every=4", "cost.workload=none"]
BF16 = ["precision.param_dtype=bfloat16"]
ENGINES = ["superround", "megakernel", "per_round"]


def _run(overrides, np_params=None):
    spec = tapi.ExperimentSpec.parse(SPEC + overrides)
    params = spec.params_from_numpy(np_params, "cpu") if np_params is not None else spec.init_params(1, "cpu")
    return spec.run_experiment(device="cpu", params=params)


def _jax_init():
    jspec = japi.ExperimentSpec.parse(SPEC)
    return jax.device_get(jspec.init_params(jax.random.PRNGKey(jspec.run.seed + 1)))


# -- the spec ------------------------------------------------------------------


@pytest.mark.parametrize("name,want", [("float32", "float32"), ("bfloat16", "bfloat16"), ("float16", "float16"),
                                       ("float", "float64"), ("half", "float16"), ("double", "float64")])
def test_precision_spec_names_normalize_like_jax(name, want):
    assert th.PrecisionSpec(param_dtype=name).param_dtype == jh.PrecisionSpec(param_dtype=name).param_dtype == want


def test_precision_spec_validation():
    assert not th.PrecisionSpec().is_active
    assert th.PrecisionSpec(param_dtype="bfloat16").is_active and th.PrecisionSpec(remat=True).is_active
    assert th.PrecisionSpec(param_dtype="bfloat16").dtype == torch.bfloat16
    with pytest.raises(ValueError):
        th.PrecisionSpec(param_dtype="int8")
    with pytest.raises((ValueError, TypeError)):
        th.PrecisionSpec(param_dtype="not_a_dtype")


def test_hier_config_precision_field():
    assert not th.HierFAVGConfig(kappa1=2, kappa2=2).precision_active
    cfg = th.HierFAVGConfig(kappa1=2, kappa2=2, precision=th.PrecisionSpec(param_dtype="bfloat16"))
    assert cfg.precision_active
    with pytest.raises(TypeError):
        th.HierFAVGConfig(kappa1=2, kappa2=2, precision="bfloat16")


@pytest.mark.parametrize("engine", ENGINES)
def test_remat_is_numerically_transparent(engine):
    """remat=True reruns each client's forward in the backward: the same
    operations, so the run is bit for bit the plain one at f32 (JAX's
    ``test_remat_policy_is_numerically_transparent``), on every engine, and
    the state stays f32."""
    np_params = _jax_init()
    (r1, s1), (r2, s2) = (_run([f"run.engine={engine}", *extra], np_params)
                          for extra in ((), ("precision.remat=true",)))
    assert r2.hier_config.precision_active and r2.hier_config.precision.remat
    assert [h.loss for h in r1.history] == [h.loss for h in r2.history]
    for k in s1.params:
        assert s2.params[k].dtype == torch.float32 and torch.equal(s1.params[k], s2.params[k])


def test_remat_with_bf16_matches_bf16_bit_for_bit():
    np_params = _jax_init()
    (_, s1), (_, s2) = (_run([*BF16, *extra], np_params) for extra in ((), ("precision.remat=true",)))
    for k in s1.params:
        assert s2.params[k].dtype == torch.bfloat16 and torch.equal(s1.params[k], s2.params[k])


@pytest.mark.parametrize("overrides", [BF16, ["precision.param_dtype=bfloat16", "precision.remat=true"],
                                       ["precision.param_dtype=float16"]])
def test_spec_json_round_trips_with_jax(overrides):
    jspec, tspec = japi.ExperimentSpec.parse(overrides), tapi.ExperimentSpec.parse(overrides)
    assert tspec.to_json() == jspec.to_json()
    assert tapi.ExperimentSpec.from_json(jspec.to_json()) == tspec
    assert japi.ExperimentSpec.from_json(tspec.to_json()) == jspec
    assert json.loads(tspec.to_json())["precision"] == json.loads(jspec.to_json())["precision"]
    assert tspec.describe() == jspec.describe()
    if not tspec.precision.remat:
        assert tspec.hier_config().precision == tspec.precision
    assert tapi.ExperimentSpec().hier_config().precision is None


# -- state dtypes and bytes ------------------------------------------------------


def _nbytes(tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


@pytest.mark.parametrize("opt_name", ["momentum", "adam"])
def test_init_state_halves_the_stacked_client_state(opt_name):
    topo = th.FedTopology(2, 4)
    p0 = {"w": torch.zeros(16, 8), "b": torch.zeros(8)}
    opt = toptim.momentum(0.1, 0.9) if opt_name == "momentum" else toptim.adam(0.01)
    cfg32 = th.HierFAVGConfig(kappa1=2, kappa2=2)
    cfg16 = dataclasses.replace(cfg32, precision=th.PrecisionSpec(param_dtype="bfloat16"))
    s32 = th.init_state(torch.Generator(), p0, opt, topo, cfg32)
    s16 = th.init_state(torch.Generator(), p0, opt, topo, cfg16)
    assert all(v.dtype == torch.bfloat16 for v in s16.params.values())
    assert _nbytes(s16.params.values()) * 2 == _nbytes(s32.params.values())
    stacked16 = [x for x in torch.utils._pytree.tree_leaves(s16.opt_state) if x.dim() >= 1]
    stacked32 = [x for x in torch.utils._pytree.tree_leaves(s32.opt_state) if x.dim() >= 1]
    if opt_name == "momentum":  # the trace rows follow the params' dtype
        assert all(x.dtype == torch.bfloat16 for x in stacked16)
        assert _nbytes(stacked16) * 2 == _nbytes(stacked32)
    else:  # Adam's moments stay f32, as in JAX
        assert all(x.dtype == torch.float32 for x in stacked16)
        assert _nbytes(stacked16) == _nbytes(stacked32)
    jopt = joptim.momentum(0.1, 0.9) if opt_name == "momentum" else joptim.adam(0.01)
    jcfg = jh.HierFAVGConfig(kappa1=2, kappa2=2, precision=jh.PrecisionSpec(param_dtype="bfloat16"))
    js = jh.init_state(jax.random.PRNGKey(0), {"w": np.zeros((16, 8), np.float32), "b": np.zeros(8, np.float32)},
                       jopt, jh.FedTopology(2, 4), jcfg)
    jleaves = [x for x in jax.tree_util.tree_leaves(js.opt_state) if getattr(x, "ndim", 0) >= 1]
    assert sorted(str(x.dtype) for x in jleaves) == sorted(str(x.dtype).removeprefix("torch.") for x in stacked16)


def test_local_step_runs_in_the_policy_dtype():
    seen = {}

    def loss_fn(p, batch, _rng):
        seen["x"] = batch["x"].dtype
        return torch.mean(torch.square(batch["x"] @ p["w"]))

    topo = th.FedTopology(1, 3)
    cfg = th.HierFAVGConfig(kappa1=1, kappa2=1, precision=th.PrecisionSpec(param_dtype="bfloat16"))
    state = th.init_state(torch.Generator(), {"w": torch.ones(4, 2)}, toptim.sgd(0.1), topo, cfg)
    step = th.build_local_step(loss_fn, toptim.sgd(0.1), precision=cfg.precision)
    state, metrics = step(state, {"x": torch.ones(3, 5, 4)})
    assert seen["x"] == torch.bfloat16 and state.params["w"].dtype == torch.bfloat16
    assert metrics["loss"].dtype == torch.float32 and metrics["grad_norm"].dtype == torch.float32


@pytest.mark.parametrize("engine", ENGINES)
def test_leaf_dtypes_per_engine(engine):
    runner, state = _run([f"run.engine={engine}", "model.optimizer=adam", "model.lr=0.01", *BF16])
    assert all(v.dtype == torch.bfloat16 for v in state.params.values())
    n = runner.topology.num_clients
    stacked = [x for x in torch.utils._pytree.tree_leaves(state.opt_state) if x.dim() >= 1 and x.shape[0] == n]
    assert stacked and all(x.dtype == torch.float32 for x in stacked)  # Adam's moments
    if engine == "megakernel":
        assert runner._engine.uses_megakernel
    runner, state = _run([f"run.engine={engine}", *BF16])
    assert all(v.dtype == torch.bfloat16 for v in state.params.values())


# -- trajectories ------------------------------------------------------------------


@pytest.mark.parametrize("engine", ENGINES)
def test_bf16_trajectory_tracks_the_jax_bf16_run(engine):
    overrides = [f"run.engine={engine}", *BF16]
    np_params = _jax_init()
    jr, js = japi.ExperimentSpec.parse(SPEC + overrides).run_experiment()
    tr, ts = _run(overrides, np_params)
    jl = np.asarray([h.loss for h in jr.history])
    tl = np.asarray([h.loss for h in tr.history])
    np.testing.assert_allclose(tl, jl, rtol=0.05, atol=0.01)
    for a, b in zip(jr.history, tr.history):
        assert (a.accuracy is None) == (b.accuracy is None)
        if a.accuracy is not None:
            assert abs(a.accuracy - b.accuracy) <= 0.01
    assert_close(to_numpy(ts.params), {k: np.asarray(v, np.float32) for k, v in jax.device_get(js.params).items()},
                 rtol=0.0, atol=1 / 64, what=f"{engine} bf16 final params")


@pytest.mark.parametrize("engine", ["superround", "megakernel"])
def test_bf16_trajectory_tracks_the_port_f32_run(engine):
    np_params = _jax_init()
    runs = {tag: _run([f"run.engine={engine}", *extra], np_params)[0]
            for tag, extra in (("f32", ()), ("bf16", BF16))}
    losses = {tag: np.asarray([h.loss for h in r.history]) for tag, r in runs.items()}
    np.testing.assert_allclose(losses["bf16"], losses["f32"], rtol=0.05, atol=0.01)
    assert losses["bf16"][-1] < losses["bf16"][0]
    accs = {tag: [h.accuracy for h in r.history if h.accuracy is not None][-1] for tag, r in runs.items()}
    assert abs(accs["bf16"] - accs["f32"]) < 0.05, accs


def _stack_clients(tree, n):
    return th.replicate_for_clients(tree, n)


@pytest.mark.parametrize("arch", ["lm-10m", "granite-3-2b", "recurrentgemma-9b"])
def test_remat_client_grads_are_bit_for_bit_on_lm_trees_and_take_the_layer_code(arch, monkeypatch):
    """On lm-10m (the ``lm_edge_niid`` tree) and smoke LMs with attention and
    RG-LRU blocks, ``_client_grads`` with remat gives the plain losses and
    gradients bit for bit. With the card test forced true, neither the
    remat forward nor its rerun in the backward calls K7 or K8 (both run
    under vmap, on wrapped tensors), so the forward takes the route of the
    rerun."""
    from repro_torch.configs import registry as treg
    from repro_torch.kernels import flash_attention as tfa
    from repro_torch.kernels import rglru_scan as trg
    from repro_torch.models import layers as tlayers
    from repro_torch.models import transformer as tt
    from repro_torch.tree import leaves

    if arch == "lm-10m":
        cfg = tapi._lm_config(tapi.ExperimentSpec.parse(["model.arch=lm-10m", "data.dataset=tokens"]))
    else:
        cfg = treg.get_smoke(arch)
    calls = {"attention": 0, "rglru_scan": 0}

    def counted(name, fn):
        def call(*args, **kwargs):
            calls[name] += 1
            return fn(*args, **kwargs)
        return call

    monkeypatch.setattr(tfa, "attention", counted("attention", tfa.attention))
    monkeypatch.setattr(trg, "rglru_scan", counted("rglru_scan", trg.rglru_scan))
    monkeypatch.setattr(tlayers, "_on_card", lambda t: True)
    params = _stack_clients(tt.init_params(torch.Generator().manual_seed(0), cfg), 2)
    rng = np.random.default_rng(0)
    if cfg.embed_inputs:
        x = torch.from_numpy(rng.integers(0, cfg.vocab_size, size=(2, 2, 16)).astype(np.int32))
    else:
        x = torch.from_numpy(rng.normal(size=(2, 2, 16, cfg.d_model)).astype(np.float32))
    y = torch.from_numpy(rng.integers(0, cfg.vocab_size, size=(2, 2, 16)).astype(np.int32))
    batch = {"inputs": x, "targets": y}
    loss = tt.make_loss_fn(cfg)
    g0, l0 = th._client_grads(loss, None)(params, batch, None)
    g1, l1 = th._client_grads(loss, th.PrecisionSpec(remat=True))(params, batch, None)
    assert calls == {"attention": 0, "rglru_scan": 0}
    assert torch.equal(l0, l1)
    for a, b in zip(leaves(g0), leaves(g1)):
        assert torch.equal(a, b)
