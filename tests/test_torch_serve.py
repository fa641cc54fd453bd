"""The serving launcher (``python -m repro_torch.launch.serve``) on the CPU:
the command line with ``--smoke --device cpu``, and ``serve`` with the JAX
init carried across against the JAX package's prefill and greedy decode on
the same prompts (f32, ``rtol=atol=1e-5``; the tokens equal)."""
import os
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jreg
from repro.models import transformer as jt
from repro_torch.configs import registry as treg
from repro_torch.launch import serve
from repro_torch import models as tmodels
from repro_torch.models import transformer as tt

ROOT = pathlib.Path(__file__).resolve().parents[1]


@pytest.mark.parametrize("arch", ["recurrentgemma-9b", "granite-3-2b", "musicgen-medium"])
def test_cli_smoke_on_cpu(arch, capsys):
    serve.main(["--arch", arch, "--smoke", "--device", "cpu", "--batch", "2", "--prompt-len", "12", "--gen", "10"])
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("prefill 2×12: ") and out[0].endswith("s")
    assert out[1].startswith("decode 2×9: ") and "tok/s" in out[1]
    assert out[2].startswith("sample ids: [")


def test_module_runs_as_a_script():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-m", "repro_torch.launch.serve", "--arch", "yi-9b", "--smoke",
                          "--device", "cpu", "--gen", "3"], capture_output=True, text=True, timeout=300, env=env)
    assert out.returncode == 0, out.stderr
    assert "sample ids:" in out.stdout


@pytest.mark.parametrize("arch", ["recurrentgemma-9b", "yi-9b"])
def test_serve_tracks_the_jax_loop(arch):
    """``serve`` with carried JAX weights: the prefill logits and every
    greedy token of the JAX launcher's loop (``repro.launch.serve``'s steps,
    same numpy prompts), past recurrentgemma-smoke's window of 8."""
    jcfg, tcfg = jreg.get_smoke(arch), treg.get_smoke(arch)
    B, P, G = 2, 6, 12
    jp = jt.init_params(jax.random.PRNGKey(0), jcfg)
    tp = tmodels.params_from_numpy(jax.device_get(jp), "cpu")
    out = serve.serve(tcfg, batch=B, prompt_len=P, gen=G, device="cpu", params=tp)
    assert out["tokens"].shape == (B, G) and out["decode_tokens_per_s"] > 0

    prompts = jnp.asarray(serve.make_prompts(tcfg, B, P))
    logits, caches = jt.prefill(jp, jcfg, prompts, P + G)
    np.testing.assert_allclose(out["prefill_logits"].numpy(), np.asarray(logits), rtol=1e-5, atol=1e-5)
    tok = jnp.argmax(logits, axis=-1).astype(jnp.int32)
    tokens = [tok]
    for t in range(G - 1):
        logits, caches = jt.decode_step(jp, jcfg, caches, tok, jnp.full((B,), P + t, jnp.int32))
        tok = jnp.argmax(logits, axis=-1).astype(jnp.int32)
        tokens.append(tok)
    np.testing.assert_array_equal(out["tokens"].numpy(), np.stack([np.asarray(t) for t in tokens], axis=1))


def test_serve_is_seeded():
    cfg = treg.get_smoke("granite-3-2b")
    a = serve.serve(cfg, batch=2, prompt_len=5, gen=4, device="cpu", seed=3)
    b = serve.serve(cfg, batch=2, prompt_len=5, gen=4, device="cpu", seed=3)
    assert torch.equal(a["prefill_logits"], b["prefill_logits"]) and torch.equal(a["tokens"], b["tokens"])
    with pytest.raises(ValueError, match="gen"):
        serve.serve(cfg, gen=0, device="cpu")
    params = tt.init_params(torch.Generator().manual_seed(3), cfg)
    c = serve.serve(cfg, batch=2, prompt_len=5, gen=4, device="cpu", seed=3, params=params)
    assert torch.equal(a["tokens"], c["tokens"])
