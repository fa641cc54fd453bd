"""Federated LM training in the port against the JAX package, on the CPU:
the token corpus, the partition, the batcher's ``batch_fn``, the
warmup-cosine schedule, the ``lm_edge_niid`` scenario and the
``launch.train`` launcher (the engine on smoke LMs' nested trees is in
``test_torch_hierfavg.py``).

Both packages get the same numpy data and the JAX init (carried across with
``params_from_numpy``). Tolerances:

* corpus, partitions and batches: bit-equal (numpy on both sides);
* schedules: one f32 ulp of the result plus one rounding in each of the
  cosine's operations carried to it (lr x 2^-22: ``frac`` and ``pi *
  frac`` move ``cos`` by up to 2 pi x 2^-24, ``cos`` itself one ulp, all
  halved by ``0.5 (1 + cos)``). ``torch.cos`` and XLA's ``cos`` differ by
  up to one ulp, XLA's jit may divide by a reciprocal, and near the end of
  the decay ``1 + cos`` cancels, so a result can sit 20 of its own ulps
  apart;
* the launcher's runs: ``torch_lm_runs``'s (loss and grad norm
  ``rtol=1e-4``, final parameters ``atol=1e-5``).

The ``lm_edge_niid`` runs against JAX are in
``test_torch_lm_train_scenario.py`` and ``test_torch_lm_train_int8.py``
(files of their own, so the suite's workers share the work out).
"""
import dataclasses
import os
import re
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data import partition as jpartition
from repro.data import pipeline as jpipeline
from repro.data import synthetic as jsyn
from repro.fed import api as japi
from repro.fed import scenarios as jscen
from repro import optim as joptim
from repro_torch.configs import registry as treg
from repro_torch.data import make_partition, pipeline as tpipeline, synthetic as tsyn
from repro_torch.fed import api as tapi
from repro_torch.fed import scenarios as tscen
from repro_torch.launch import train as ttrain
from repro_torch import optim as toptim
from repro_torch.testing.parity import assert_close, to_numpy

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from torch_lm_runs import INT8_EF, LOSS_RTOL, PARAM_ATOL  # noqa: E402


@pytest.fixture(autouse=True)
def _one_intra_op_thread():
    """One intra-op thread a test: the smoke and lm-10m tensors are small,
    and beside the suite's other workers a product spread over every core
    only contends."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# -- data -----------------------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_token_corpus_is_bit_equal_to_jax(seed):
    kw = dict(num_sequences=96, seq_len=24, vocab=40, num_classes=6, concentration=0.2)
    want = jsyn.token_corpus(np.random.default_rng(seed), **kw)
    got = tsyn.token_corpus(np.random.default_rng(seed), **kw)
    assert got.tokens.dtype == want.tokens.dtype == np.int32
    np.testing.assert_array_equal(got.tokens, want.tokens)
    np.testing.assert_array_equal(got.labels, want.labels)
    assert (got.num_samples, got.num_classes) == (want.num_samples, want.num_classes)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_embedding_corpus_is_bit_equal_to_jax(seed):
    kw = dict(num_sequences=40, seq_len=12, d_model=16, num_classes=5)
    for got, want in zip(tsyn.embedding_corpus(np.random.default_rng(seed), **kw),
                         jsyn.embedding_corpus(np.random.default_rng(seed), **kw)):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("kind", ["iid", "simple_niid", "edge_iid", "edge_niid"])
def test_make_partition_is_bit_equal_to_jax(kind):
    labels = np.random.default_rng(3).integers(0, 8, size=400).astype(np.int32)
    want = jpartition.partition(kind, labels, 2, 4, np.random.default_rng(5))
    got = make_partition(kind, labels, 2, 4, np.random.default_rng(5))
    assert len(got) == len(want) == 8
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def _token_batchers():
    corp = jsyn.token_corpus(np.random.default_rng(0), num_sequences=64, seq_len=16, vocab=30, num_classes=4)
    parts = jpartition.partition("edge_niid", corp.labels, 2, 2, np.random.default_rng(1))
    shift = lambda b: {"inputs": b["tokens"][..., :-1], "targets": b["tokens"][..., 1:]}
    make = lambda mod: mod.FederatedBatcher({"tokens": corp.tokens}, parts, batch_size=3, seed=7, batch_fn=shift)
    return make(jpipeline), make(tpipeline), make


def _assert_batches_equal(got, want):
    assert sorted(got) == sorted(want) == ["inputs", "targets"]
    for k in want:
        assert got[k].dtype == want[k].dtype == np.int32
        np.testing.assert_array_equal(got[k], want[k])


def test_batcher_batch_fn_gives_jax_batches_and_survives_a_state_round_trip():
    jb, tb, make = _token_batchers()
    for _ in range(10):  # 10 draws cross several epochs of the 16-sample clients
        _assert_batches_equal(tb.next_batch(), jb.next_batch())
    _assert_batches_equal(tb.next_batches(3), jb.next_batches(3))
    state = tb.state_dict()
    assert state == jb.state_dict()
    fresh = make(tpipeline)
    fresh.load_state_dict(state)
    for _ in range(4):
        want = jb.next_batch()
        _assert_batches_equal(tb.next_batch(), want)
        _assert_batches_equal(fresh.next_batch(), want)


# -- schedules ------------------------------------------------------------------------


def _f32_ulp(x: np.ndarray) -> np.ndarray:
    return np.spacing(np.abs(x).astype(np.float32))


@pytest.mark.parametrize("lr,warmup,total", [(3e-4, 20, 96), (3e-4, 20, 16), (0.15, 7, 50), (1e-2, 0, 10),
                                             (3e-4, 1, 1)])
def test_warmup_cosine_within_a_rounding_per_operation_of_jax(lr, warmup, total):
    counts = np.arange(0, max(3 * warmup, total) + 2)  # 0 ... 3 x warmup, the boundary included
    jf, tf = joptim.warmup_cosine(lr, warmup, total), toptim.warmup_cosine(lr, warmup, total)
    got = np.array([float(tf(torch.tensor(c, dtype=torch.int32))) for c in counts], np.float32)
    tol = _f32_ulp(got) + np.float32(lr) * 2.0**-22
    for fn in (jf, jax.jit(jf)):  # XLA may divide by a reciprocal under jit
        want = np.array([float(fn(jnp.asarray(c, jnp.int32))) for c in counts], np.float32)
        bad = np.abs(got - want) > tol
        assert not bad.any(), (counts[bad], got[bad], want[bad])
    if warmup:
        assert got[0] == 0.0  # the first local step does not move the parameters
    assert got.dtype == np.float32


@pytest.mark.parametrize("alpha", [0.0, 0.1])
def test_cosine_decay_within_a_rounding_per_operation_of_jax(alpha):
    counts = np.arange(0, 40)
    jf, tf = joptim.cosine_decay(0.2, 30, alpha), toptim.cosine_decay(0.2, 30, alpha)
    got = np.array([float(tf(torch.tensor(c))) for c in counts], np.float32)
    want = np.array([float(jf(jnp.asarray(c))) for c in counts], np.float32)
    np.testing.assert_array_less(np.abs(got - want), _f32_ulp(got) + np.float32(0.2) * 2.0**-22 + 1e-30)


# -- the scenario ---------------------------------------------------------------------


@pytest.mark.parametrize("overrides", [[], ["model.arch=lm-100m", "run.num_rounds=8"], INT8_EF])
def test_lm_spec_json_round_trips_between_packages(overrides):
    jspec, tspec = jscen.get("lm_edge_niid", overrides=overrides), tscen.get("lm_edge_niid", overrides=overrides)
    assert tapi.ExperimentSpec.from_json(jspec.to_json()) == tspec
    assert japi.ExperimentSpec.from_json(tspec.to_json()) == jspec
    assert tspec.describe() == jspec.describe()


def test_lm_configs_match_jax():
    for arch in ("lm-10m", "lm-100m"):
        jspec = jscen.get("lm_edge_niid", overrides=[f"model.arch={arch}"])
        tspec = tscen.get("lm_edge_niid", overrides=[f"model.arch={arch}"])
        jcfg, tcfg = japi._lm_config(jspec), tapi._lm_config(tspec)
        fields = [f.name for f in dataclasses.fields(jcfg) if f.name != "fed"]
        assert {f: getattr(tcfg, f) for f in fields} == {f: getattr(jcfg, f) for f in fields}
        assert tcfg.vocab_size == 512


@pytest.mark.parametrize("overrides", [["model.arch=lm-10m"], ["data.dataset=tokens"]])
def test_lm_data_mismatch_raises_jax_value_error(overrides):
    with pytest.raises(ValueError) as want:
        jscen.get("quickstart", overrides=overrides).build()
    with pytest.raises(ValueError, match=re.escape(str(want.value))):
        tscen.get("quickstart", overrides=overrides).build(device="cpu")


# -- the launcher ---------------------------------------------------------------------


@pytest.mark.parametrize("arch", ["granite-3-2b", "recurrentgemma-9b", "internvl2-2b"])
def test_train_main_runs_and_prints_its_records(arch, capsys):
    runner = ttrain.main(["--arch", arch, "--smoke", "--rounds", "2", "--device", "cpu"])
    out = capsys.readouterr().out.strip().splitlines()
    assert len(out) == len(runner.history) == 2
    for line, h in zip(out, runner.history):
        assert re.fullmatch(rf"round +{h.round} step +{h.step} loss \d+\.\d{{4}} alive 4", line), line
        assert np.isfinite(h.loss)
    assert runner.history[-1].step == 2 * min(treg.get_smoke(arch).fed.kappa1, 4)


@pytest.mark.parametrize("flags", [["--inject-failures"], ["--stragglers"], ["--inject-failures", "--stragglers"],
                                   []])
def test_train_checkpoints_and_resumes_with_failure_models(flags, tmp_path, capsys):
    """``--ckpt-dir`` saves every 4 rounds (keeping 2); ``--resume`` goes on
    from the latest, restoring the failure models; the resumed rounds equal
    those of a straight run. ``--inject-failures`` is
    ``FailureSimulator(n, p_fail=0.1, seed=1)`` and ``--stragglers``
    ``StragglerModel(n, seed=2)``, as in the JAX launcher."""
    from repro.fed.failures import FailureSimulator as JFailures, StragglerModel as JStragglers

    base = ["--arch", "granite-3-2b", "--smoke", "--device", "cpu", *flags]
    straight = ttrain.main(base + ["--rounds", "6"])
    ttrain.main(base + ["--rounds", "4", "--ckpt-dir", str(tmp_path)])
    assert sorted(os.listdir(tmp_path)) == ["step_000000000008", "step_000000000008.COMMITTED"]
    capsys.readouterr()
    resumed = ttrain.main(base + ["--rounds", "6", "--ckpt-dir", str(tmp_path), "--resume"])
    assert capsys.readouterr().out.splitlines()[0] == "resumed at round 4"
    key = lambda h: (h.round, h.step, h.loss, h.mask_alive)
    assert [key(h) for h in resumed.history] == [key(h) for h in straight.history[4:]]
    n = straight.topology.num_clients
    jf, js = JFailures(n, p_fail=0.1, seed=1), JStragglers(n, seed=2)
    want = []
    for _ in range(6):
        m = np.ones(n, np.float32)
        if "--inject-failures" in flags:
            m = m * jf.step()
        if "--stragglers" in flags:
            m = m * js.survivors(straight.hier_config.kappa1)[0]
        want.append(int(m.sum()))
    assert [h.mask_alive for h in straight.history] == want


@pytest.mark.parametrize("arch", ["xlstm-350m", "deepseek-v3-671b", "arctic-480b"])
def test_train_main_tracks_the_jax_launcher(arch, monkeypatch, capsys):
    """``--arch {xlstm, deepseek-v3, arctic} --smoke --rounds 2``: the JAX
    launcher and the port's (the JAX init carried across) over the same
    corpus, SGD with exponential decay: every round's loss (CE + the MoE
    aux loss) and grad_norm within ``LOSS_RTOL``, the final parameters
    within ``PARAM_ATOL``."""
    import sys

    from repro.configs import registry as jreg
    from repro.launch import train as jtrain
    from repro.models import transformer as jt
    from repro_torch import models as tmodels

    runs = {}

    def recording(base, key):
        class Recording(base):
            def run(self, *a, **k):
                runs[key] = (self, super().run(*a, **k))
                return runs[key][1]
        return Recording

    jparams = jax.device_get(jt.init_params(jax.random.PRNGKey(0), jreg.get_smoke(arch)))
    monkeypatch.setattr(jtrain, "FederatedRunner", recording(jtrain.FederatedRunner, "jax"))
    monkeypatch.setattr(sys, "argv", ["train", "--arch", arch, "--smoke", "--rounds", "2"])
    jtrain.main()
    monkeypatch.setattr(ttrain, "FederatedRunner", recording(ttrain.FederatedRunner, "port"))
    monkeypatch.setattr(ttrain.transformer, "init_params",
                        lambda gen, c: tmodels.params_from_numpy(jparams, "cpu"))
    ttrain.main(["--arch", arch, "--smoke", "--rounds", "2", "--device", "cpu"])
    capsys.readouterr()
    (jr, js), (tr, ts) = runs["jax"], runs["port"]
    assert len(tr.history) == len(jr.history) == 2
    for a, b in zip(jr.history, tr.history):
        assert (b.round, b.step, b.mask_alive) == (a.round, a.step, a.mask_alive)
        assert np.isfinite(b.loss) and b.loss == pytest.approx(a.loss, rel=LOSS_RTOL), (a.round, b.loss, a.loss)
        assert b.grad_norm == pytest.approx(a.grad_norm, rel=LOSS_RTOL), a.round
    assert_close(to_numpy(ts.params), jax.device_get(js.params), rtol=0.0, atol=PARAM_ATOL, what="final params")
