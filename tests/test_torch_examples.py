"""The port's examples (``repro_torch.examples``) against the JAX package
on the CPU.

``quickstart`` and ``compare_topologies`` (a ragged three-level tree cut
to 10 rounds) run from
the JAX init carried across, and each training run is held to the same
spec trained by the JAX package: per-round loss and grad norm
``rtol=1e-4``, accuracy within 0.01, T, E and wire MB to 1e-12 relative.
``serve_lm`` takes the JAX init of the ``lm-serve`` cut through
``models.params_from_numpy``: its prefill logits within 1e-4 of the
largest of JAX's, the same greedy first token. Its later tokens are drawn
with ``torch.multinomial`` from a seeded ``torch.Generator``, which no JAX
draw matches; the test holds them to the same draws on a second run.
``train_hier_lm`` trains lm-10m (16-token sequences) for 2 rounds into a
checkpoint, held to JAX, and resumes from it for one more.
"""
import dataclasses
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.paper import LM_100M as JLM_100M
from repro.fed import scenarios as jscen
from repro.models import transformer as jt
from repro_torch import models as tmodels
from repro_torch.examples import compare_topologies, quickstart, serve_lm, train_hier_lm
from repro_torch.experiments import common
from repro_torch.models import transformer as tt

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from torch_jax_runs import held_to_jax, jax_init, jax_spec  # noqa: E402


@pytest.fixture(autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_quickstart_tracks_jax(capsys):
    with common.recorded_runs() as runs:
        runner = quickstart.main(["--device", "cpu"], init=jax_init)
    assert runs == [runner] and runner.spec.name == "quickstart" and len(runner.history) == 24
    held_to_jax(runner)
    assert "final accuracy:" in capsys.readouterr().out


def test_compare_topologies_tracks_jax():
    """The ragged two-level-region tree cut to 10 rounds (one region sync),
    the baselines at their own rounds (held in test_torch_experiments)."""
    argv = ["--fanout", "16,12,10,7,5/3,2/2", "--kappas", "6,5,2", "--rounds", "10", "--device", "cpu"]
    with common.recorded_runs() as runs:
        out = compare_topologies.main(argv, init=jax_init)
    assert len(out) == len(runs) == 3 and [len(r.history) for r in runs] == [10, 60, 10]
    tr = runs[2]
    assert tr.spec.topology.fanouts == "16,12,10,7,5/3,2/2" and tr.spec.data.partition == "simple_niid"
    held_to_jax(tr)


def test_serve_lm_prefill_and_first_token_match_jax():
    jcfg = dataclasses.replace(JLM_100M, name="lm-serve", num_layers=4, d_model=256, num_heads=8,
                               num_kv_heads=4, d_ff=768, vocab_size=512)
    tcfg = serve_lm.serve_config()
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    jp = jt.init_params(jax.random.PRNGKey(0), jcfg)
    params = tmodels.params_from_numpy(jax.device_get(jp), "cpu",
                                       like=tt.init_params(torch.Generator().manual_seed(0), tcfg))
    out = serve_lm.main(["--device", "cpu", "--gen", "6"], params=params)
    prompts = jnp.asarray(np.random.default_rng(0).integers(0, jcfg.vocab_size, size=(4, 32)), jnp.int32)
    np.testing.assert_array_equal(out["prompts"].numpy(), np.asarray(prompts))
    want, _ = jax.jit(lambda p, x: jt.prefill(p, jcfg, x, 32 + 6))(jp, prompts)
    want = np.asarray(want)
    got = out["prefill_logits"].numpy()
    err = float(np.abs(got - want).max())
    assert err <= 1e-4 * float(np.abs(want).max()), err
    np.testing.assert_array_equal(out["tokens"][:, 0].numpy(), want.argmax(-1))
    assert tuple(out["tokens"].shape) == (4, 6)
    assert bool(((out["tokens"] >= 0) & (out["tokens"] < jcfg.vocab_size)).all())
    again = serve_lm.main(["--device", "cpu", "--gen", "6"], params=params)
    assert torch.equal(again["tokens"], out["tokens"])  # the sampler's generator is seeded


def test_train_hier_lm_default_checkpoint_dir_is_not_jax_s():
    assert train_hier_lm.default_ckpt_dir() != "/tmp/hier_lm_ckpt"
    assert train_hier_lm.default_ckpt_dir().endswith("hier_lm_ckpt_torch")


def test_train_hier_lm_checkpoints_and_resumes(tmp_path, capsys):
    argv = ["--preset", "10m", "--seq-len", "16", "--ckpt-dir", str(tmp_path / "ckpt"), "--set",
            "run.checkpoint_every=2", "--device", "cpu"]
    runner, state = train_hier_lm.main(argv + ["--rounds", "2"], init=jax_init)
    want = jscen.get("lm_edge_niid", overrides=["model.arch=lm-10m", "run.num_rounds=2", "data.seq_len=16",
                                                 f"run.checkpoint_dir={tmp_path / 'ckpt'}", "run.checkpoint_every=8",
                                                 "run.checkpoint_every=2"])
    assert jax_spec(runner.spec).to_dict() == want.to_dict()
    held_to_jax(runner, [f"run.checkpoint_dir={tmp_path / 'jax'}"])
    assert int(state.step) == 8 and os.listdir(tmp_path / "ckpt")
    resumed, rstate = train_hier_lm.main(argv + ["--rounds", "3", "--resume"])  # the checkpoint's params
    assert [h.round for h in resumed.history] == [2] and int(rstate.step) == 12
    assert "loss" in capsys.readouterr().out
