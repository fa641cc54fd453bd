"""The port's ``CheckpointManager`` and resume path: the JAX package's
on-disk layout for the same state, save/restore of a ``FedState`` (anchor
and residual present or None, bf16 leaves, the generator's state),
keep-k, corrupt and uncommitted entries skipped as JAX skips them, and a
resumed run bit-equal to an uninterrupted one on the CPU (per-round loop
and superround engine, with failure and straggler models whose states
ride in the metadata).
"""
import json
import os

import jax
import numpy as np
import pytest
import torch

from repro.checkpoint import CheckpointManager as JManager
from repro.core import hierfavg as jh
from repro.core.hierarchy import parse_fanouts as jparse
from repro.fed import api as japi
from repro.fed import transport as jtransport
from repro import optim as joptim
from repro_torch import optim as toptim
from repro_torch.checkpoint import CheckpointManager
from repro_torch.core import hierfavg as th
from repro_torch.core.hierarchy import parse_fanouts as tparse
from repro_torch.fed import api as tapi
from repro_torch.fed import scenarios as tscen
from repro_torch.fed import transport as ttransport
from repro_torch.tree import leaves

MODEL = ["data.dim=6", "model.hidden=8", "data.num_classes=4"]


def _states(transport=None, dtype="float32", opt="adam"):
    jspec, tspec = japi.ExperimentSpec.parse(MODEL), tapi.ExperimentSpec.parse(MODEL)
    np_params = jax.device_get(jspec.init_params(jax.random.PRNGKey(1)))
    prec = dict(precision=th.PrecisionSpec(param_dtype=dtype)) if dtype != "float32" else {}
    jprec = dict(precision=jh.PrecisionSpec(param_dtype=dtype)) if dtype != "float32" else {}
    tcfg = th.HierFAVGConfig(kappa1=2, kappa2=2, transport=ttransport.TransportSpec.parse(transport)
                             if transport else None, **prec)
    jcfg = jh.HierFAVGConfig(kappa1=2, kappa2=2, transport=jtransport.TransportSpec.parse(transport)
                             if transport else None, **jprec)
    topt, jopt = (toptim.adam(0.01), joptim.adam(0.01)) if opt == "adam" else (toptim.sgd(0.1), joptim.sgd(0.1))
    ts = th.init_state(torch.Generator().manual_seed(3), tspec.params_from_numpy(np_params, "cpu"), topt,
                       tparse("3,3/2"), tcfg)
    js = jh.init_state(jax.random.PRNGKey(3), jax.tree_util.tree_map(jax.numpy.asarray, np_params), jopt,
                       jparse("3,3/2"), jcfg)
    return ts, js


@pytest.mark.parametrize("transport", [None, "int8:256/int8:256", "int8_ef:128/identity"])
def test_on_disk_layout_matches_jax(tmp_path, transport):
    """Same files, same meta keys, same leaf count and the same shapes leaf
    by leaf, except the rng leaf (a JAX key against the generator's bytes)."""
    ts, js = _states(transport)
    meta = {"round": 4, "batcher": {"seed": 0, "cursors": [[0, 8]]}}
    CheckpointManager(str(tmp_path / "t"), keep=2).save(12, ts, meta)
    JManager(str(tmp_path / "j"), keep=2).save(12, js, meta)
    for root in ("t", "j"):
        assert sorted(os.listdir(tmp_path / root)) == ["step_000000000012", "step_000000000012.COMMITTED"]
        assert sorted(os.listdir(tmp_path / root / "step_000000000012")) == ["meta.json", "payload.npz"]
    tm, jm = (json.loads((tmp_path / r / "step_000000000012" / "meta.json").read_text()) for r in ("t", "j"))
    assert sorted(tm) == sorted(jm) and tm["num_leaves"] == jm["num_leaves"] and tm["user"] == jm["user"]
    rng_leaf = len(list(leaves([ts.step, ts.params, ts.opt_state])))
    assert [s for i, s in enumerate(tm["shapes"]) if i != rng_leaf] == [
        s for i, s in enumerate(jm["shapes"]) if i != rng_leaf]
    assert [d for i, d in enumerate(tm["dtypes"]) if i != rng_leaf] == [
        d for i, d in enumerate(jm["dtypes"]) if i != rng_leaf]


@pytest.mark.parametrize("transport,dtype", [(None, "float32"), ("int8_ef:128/int8_ef:128", "float32"),
                                             (None, "bfloat16")])
def test_save_restore_round_trips_a_fed_state(tmp_path, transport, dtype):
    ts, _ = _states(transport, dtype)
    ts.rng.manual_seed(11)
    torch.rand(5, generator=ts.rng)  # move the generator off its seed
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(5, ts, {"round": 2, "failures": {"alive": np.array([True, False])}})
    template, _ = _states(transport, dtype)
    got, meta = mgr.restore_latest(template)
    assert meta["round"] == 2 and np.array_equal(meta["failures"]["alive"], [True, False])
    assert meta["failures"]["alive"].dtype == bool
    assert type(got) is type(ts) and (got.anchor is None) == (ts.anchor is None)
    assert (got.residual is None) == (ts.residual is None)
    for a, b in zip(leaves([got.step, got.params, got.opt_state, got.anchor, got.residual]),
                    leaves([ts.step, ts.params, ts.opt_state, ts.anchor, ts.residual])):
        if b is None:
            assert a is None
            continue
        assert a.dtype == b.dtype and a.shape == b.shape and torch.equal(a, b)
    assert torch.equal(got.rng.get_state(), ts.rng.get_state())
    assert torch.equal(torch.rand(3, generator=got.rng), torch.rand(3, generator=ts.rng))


def test_a_template_without_an_anchor_skips_a_checkpoint_with_one(tmp_path):
    """The leaf lists differ (None holds no leaf), so restore refuses that
    entry and ``restore_latest`` falls back to an older one, as JAX's."""
    with_anchor, _ = _states("int8:256/int8:256", opt="sgd")
    plain, _ = _states(None, opt="sgd")
    mgr = CheckpointManager(str(tmp_path), keep=3)
    mgr.save(1, plain, {"round": 1})
    mgr.save(2, with_anchor, {"round": 2})
    with pytest.raises(ValueError, match="leaves, template has"):
        mgr.restore(2, plain)
    _, meta = mgr.restore_latest(_states(None, opt="sgd")[0])
    assert meta["round"] == 1


def test_keep_k_corrupt_and_uncommitted_entries(tmp_path):
    ts, _ = _states(None)
    mgr = CheckpointManager(str(tmp_path), keep=2)
    for step in (1, 2, 3):
        mgr.save(step, ts, {"round": step})
    assert mgr.committed_steps() == [2, 3]
    assert not (tmp_path / "step_000000000001").exists()
    # an uncommitted newer entry (a crash before the marker) is never read
    os.makedirs(tmp_path / "step_000000000009")
    assert mgr.restore_latest(_states(None)[0])[1]["round"] == 3
    # a corrupt newest committed entry is skipped for the older one
    (tmp_path / "step_000000000003" / "payload.npz").write_bytes(b"not a zip file")
    assert mgr.restore_latest(_states(None)[0])[1]["round"] == 2
    (tmp_path / "step_000000000002" / "meta.json").write_text("{")
    assert mgr.restore_latest(_states(None)[0]) is None


RESUME = ["run.num_rounds=8", "run.eval_every=2", "failures.p_fail=0.15", "failures.straggler_sigma=0.3"]


@pytest.mark.parametrize("engine,every", [("per_round", 3), ("auto", 4)])
def test_a_resumed_run_is_bit_equal_to_a_straight_run(tmp_path, engine, every):
    """``quickstart`` with failures and stragglers: 8 rounds straight, and 8
    rounds as a run cut after its checkpoint at round ``every`` then
    resumed by a fresh runner; final parameters, optimizer state and the
    resumed rounds' records are bit-equal."""
    base = tscen.get("quickstart", overrides=RESUME + [f"run.engine={engine}", f"run.checkpoint_every={every}"])
    params = base.init_params(1, "cpu")
    straight, s_state = base.with_overrides([f"run.checkpoint_dir={tmp_path / 'a'}"]).run_experiment(
        device="cpu", params={k: v.clone() for k, v in params.items()})
    cut = base.with_overrides([f"run.checkpoint_dir={tmp_path / 'b'}", f"run.num_rounds={every}"])
    cut.run_experiment(device="cpu", params={k: v.clone() for k, v in params.items()})
    resumed, r_state = base.with_overrides([f"run.checkpoint_dir={tmp_path / 'b'}"]).run_experiment(
        device="cpu", params={k: v.clone() for k, v in params.items()}, resume=True)
    assert [h.round for h in resumed.history] == list(range(every, 8))
    fields = lambda h: (h.round, h.step, h.loss, h.grad_norm, h.mask_alive, h.accuracy, h.sim_time_s, h.wire_mb)
    assert [fields(h) for h in resumed.history] == [fields(h) for h in straight.history[every:]]
    assert int(r_state.step) == int(s_state.step) == 8 * 4
    for a, b in zip(leaves([r_state.params, r_state.opt_state]), leaves([s_state.params, s_state.opt_state])):
        assert torch.equal(a, b)
    assert resumed.failures.state_dict()["rng"] == straight.failures.state_dict()["rng"]


def test_resume_without_a_checkpoint_dir_raises_like_jax():
    spec = tscen.get("quickstart", overrides=["run.num_rounds=2"])
    with pytest.raises(ValueError, match=r"run_experiment\(resume=True\) needs run.checkpoint_dir"):
        spec.run_experiment(device="cpu", resume=True)


def test_resume_from_an_empty_dir_starts_at_round_zero(tmp_path):
    spec = tscen.get("quickstart", overrides=["run.num_rounds=2", f"run.checkpoint_dir={tmp_path}"])
    runner = spec.build(device="cpu")
    state, start = runner.restore_or_init(torch.Generator().manual_seed(0), spec.init_params(1, "cpu"))
    assert start == 0 and int(state.step) == 0
