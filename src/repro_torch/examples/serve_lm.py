"""Serve the (cloud) model: prefill a batch of prompts, then decode with a
KV cache, sampling each token.

    python -m repro_torch.examples.serve_lm --batch 4 --gen 24 [--device cpu]

The model is the ``lm-serve`` cut of lm-100m (4 layers, d_model 256, 8
heads on 4 KV heads, d_ff 768, a vocabulary of 512) from a seeded init. On
the card each prefill runs K7 once a layer. The first token is the
prefill's argmax; later ones are drawn with ``torch.multinomial`` from the
softmax at ``--temperature``, from a ``torch.Generator`` seeded with 1 (the
JAX example's ``jax.random.categorical`` draws cannot be matched).
"""
import argparse
import dataclasses
import time

import numpy as np
import torch

from repro_torch.configs.paper import LM_100M
from repro_torch.device import resolve_device
from repro_torch.experiments.common import add_device_argument
from repro_torch.models import transformer


def serve_config():
    """The ``lm-serve`` cut of lm-100m."""
    return dataclasses.replace(
        LM_100M, name="lm-serve", num_layers=4, d_model=256, num_heads=8,
        num_kv_heads=4, d_ff=768, vocab_size=512,
    )


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(argv=None, *, params=None):
    """Returns the prompts, the prefill's last logits, the generated tokens
    and the two timings. ``params`` replaces the seeded init."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=24)
    ap.add_argument("--temperature", type=float, default=0.8)
    add_device_argument(ap)
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    cfg = serve_config()
    B, P = args.batch, args.prompt_len
    max_len = P + args.gen
    with torch.inference_mode():
        if params is None:
            params = transformer.init_params(torch.Generator(device=device).manual_seed(0), cfg)
        rng = np.random.default_rng(0)
        prompts = torch.from_numpy(rng.integers(0, cfg.vocab_size, size=(B, P)).astype(np.int32)).to(device)

        _sync(device)
        t0 = time.perf_counter()
        logits, caches = transformer.prefill(params, cfg, prompts, max_len)
        _sync(device)
        t_prefill = time.perf_counter() - t0
        prefill_logits = logits

        gen = torch.Generator(device=device).manual_seed(1)
        tok = torch.argmax(logits, dim=-1).to(torch.int32)
        out = [tok]
        t0 = time.perf_counter()
        for t in range(args.gen - 1):
            pos = torch.full((B,), P + t, dtype=torch.int32, device=device)
            logits, caches = transformer.decode_step(params, cfg, caches, tok, pos)
            probs = torch.softmax(logits.float() / args.temperature, dim=-1)
            tok = torch.multinomial(probs, 1, generator=gen)[:, 0].to(torch.int32)
            out.append(tok)
        _sync(device)
        t_decode = time.perf_counter() - t0

    tokens = torch.stack(out, dim=1)
    print(f"prefill: {B}×{P} tokens in {t_prefill*1e3:.0f} ms "
          f"({B*P/t_prefill:.0f} tok/s)")
    print(f"decode : {B}×{args.gen-1} tokens in {t_decode*1e3:.0f} ms "
          f"({B*(args.gen-1)/max(t_decode,1e-9):.0f} tok/s)")
    for b in range(min(B, 2)):
        print(f"request {b}: prompt={prompts[b, :8].cpu().numpy()}... -> "
              f"generated={tokens[b, :12].cpu().numpy()}...")
    return {"prompts": prompts, "prefill_logits": prefill_logits, "tokens": tokens,
            "prefill_s": t_prefill, "decode_s": t_decode}


if __name__ == "__main__":
    main()
