"""Serving launcher: prefill a request batch, then decode greedily with the
KV ring caches and RG-LRU states; the counterpart of ``repro.launch.serve``.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch yi-9b --smoke \\
        --batch 4 --prompt-len 32 --gen 16 [--device cpu]

Runs on ``cuda`` unless ``--device`` names another device; without a GPU
and without ``--device`` it raises. On the card every attention layer of
the prefill runs K7 (MLA with v zero-padded to its q/k head dim) and every
RG-LRU layer K8 (``models.transformer``); the decode steps, the MoE and the
mLSTM / sLSTM cells run the layer code. With mLSTM blocks a prompt longer
than ``mlstm_chunk`` must be a multiple of it. Everything runs under
``torch.inference_mode()``.
"""
from __future__ import annotations

import argparse
import time
from typing import Any, Dict, Optional

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.configs.registry import ARCH_IDS, get_config, get_smoke
from repro_torch.device import resolve_device
from repro_torch.models import transformer


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def make_prompts(cfg: ArchConfig, batch: int, prompt_len: int, seed: int = 0) -> np.ndarray:
    """Random prompts from ``seed``, as the JAX launcher draws them: token ids
    (B, P), or f32 embeddings (B, P, d) for stub-frontend archs."""
    rng = np.random.default_rng(seed)
    if cfg.embed_inputs:
        return rng.integers(0, cfg.vocab_size, size=(batch, prompt_len)).astype(np.int32)
    return rng.normal(size=(batch, prompt_len, cfg.d_model)).astype(np.float32)


def serve(cfg: ArchConfig, *, batch: int = 4, prompt_len: int = 32, gen: int = 16, device=None, seed: int = 0,
          params: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
    """Prefill ``batch`` random prompts of ``prompt_len`` tokens, then
    ``gen - 1`` greedy decode steps. ``params`` defaults to
    ``transformer.init_params`` from a generator seeded with ``seed`` on the
    device. Returns the timings (host clock, ending in a device
    synchronise), the prefill's last logits and every generated token."""
    if gen < 1:
        raise ValueError(f"gen must be >= 1, got {gen}")
    device = resolve_device(device)
    B, P = batch, prompt_len
    max_len = P + gen
    with torch.inference_mode():
        if params is None:
            params = transformer.init_params(torch.Generator(device=device).manual_seed(seed), cfg)
        prompts = torch.from_numpy(make_prompts(cfg, B, P, seed)).to(device)
        _sync(device)
        t0 = time.perf_counter()
        logits, caches = transformer.prefill(params, cfg, prompts, max_len)
        _sync(device)
        prefill_s = time.perf_counter() - t0
        prefill_logits = logits
        tok = torch.argmax(logits, dim=-1).to(torch.int32)
        tokens = [tok]
        t0 = time.perf_counter()
        for t in range(gen - 1):
            pos = torch.full((B,), P + t, dtype=torch.int32, device=device)
            # stub frontend: feed a zero embedding (the JAX launcher's demo)
            nxt = tok if cfg.embed_inputs else torch.zeros((B, cfg.d_model), dtype=torch.float32, device=device)
            logits, caches = transformer.decode_step(params, cfg, caches, nxt, pos)
            tok = torch.argmax(logits, dim=-1).to(torch.int32)
            tokens.append(tok)
        _sync(device)
        decode_s = time.perf_counter() - t0
    return {
        "device": str(device),
        "batch": B,
        "prompt_len": P,
        "gen": gen,
        "prefill_s": prefill_s,
        "prefill_tokens_per_s": B * P / prefill_s,
        "decode_s": decode_s,
        "decode_tokens_per_s": B * (gen - 1) / max(decode_s, 1e-9),
        "prefill_logits": prefill_logits,
        "tokens": torch.stack(tokens, dim=1),  # (B, gen)
        "caches": caches,
    }


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", required=True, choices=list(ARCH_IDS) + ["lm-100m"])
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    args = ap.parse_args(argv)

    cfg = get_smoke(args.arch) if args.smoke else get_config(args.arch)
    out = serve(cfg, batch=args.batch, prompt_len=args.prompt_len, gen=args.gen, device=args.device)
    B, P, G = args.batch, args.prompt_len, args.gen
    print(f"prefill {B}×{P}: {out['prefill_s']:.2f}s")
    print(f"decode {B}×{G - 1}: {out['decode_s']:.2f}s ({out['decode_tokens_per_s']:.1f} tok/s)")
    print("sample ids:", out["tokens"][:4, -1].cpu().numpy())


if __name__ == "__main__":
    main()
