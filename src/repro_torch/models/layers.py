"""Transformer layers for the LM stack, the counterpart of ``repro.models.layers``.

RMSNorm, RoPE, GQA/MQA attention (full-causal and sliding-window, the
full-sequence path and the cached single-token decode) and the SwiGLU MLP,
over plain dictionaries of tensors with the JAX package's names, shapes and
layouts. MLA and MoE are not ported yet: ``transformer`` refuses configs
that need them, naming ROADMAP item 13.

Full-sequence attention (``_full_attention``) has two routes:

* **K7** (``kernels.flash_attention``): on CUDA tensors that no
  transform would differentiate or batch (grad mode off, or no input
  requiring grad; and no input wrapped by a ``torch.func`` transform), for
  the default positions ``arange(S)`` and no cache-slot mask. That is the
  function of ``attention_ref`` (causal, optional window), which the JAX
  docstring of ``chunked_causal_attention`` says the Pallas kernel takes
  over on the accelerator.
* **Layer code** otherwise: ``causal_attention`` or, above
  ``cfg.attn_chunk``, ``chunked_causal_attention``, as the JAX package
  computes them (probabilities cast to the value dtype before the PV
  product). CPU tensors, every forward that autograd records or that runs
  under ``grad`` / ``vmap`` (K7 has no backward and takes no batched
  tensors; JAX's loss never calls a Pallas kernel either), explicit
  positions, and the decode step (one query against a ring cache with a
  slot mask) take it.

Parameters are created by ``init_*`` from a ``torch.Generator``; the numbers
differ from the JAX init's (the tests carry the JAX init across with
``models.params_from_numpy``). ``stack`` prefixes every leaf with leading
axes, which is how ``transformer.init_params`` builds the superblock stack
that JAX builds with ``jax.vmap``.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels import flash_attention as _fa

Params = Dict[str, torch.Tensor]
_NEG = -1e30  # the JAX package's mask value


# ---------------------------------------------------------------------------
# Norms / embeddings / RoPE
# ---------------------------------------------------------------------------

def init_rmsnorm(d: int, dtype: torch.dtype, device=None, stack: Sequence[int] = ()) -> torch.Tensor:
    return torch.ones((*stack, d), dtype=dtype, device=device)


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    var = torch.mean(torch.square(xf), dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps) * scale.float()
    return out.to(x.dtype)


def _init_dense(gen: torch.Generator, shape: Sequence[int], dtype: torch.dtype, scale: Optional[float] = None,
                stack: Sequence[int] = ()) -> torch.Tensor:
    """N(0, 1) * std drawn in f32 (std = fan_in ** -0.5, fan_in = shape[0]),
    then cast, as JAX's ``_init_dense``; one leaf at a time and scaled in
    place, so a bf16 model never holds more than one f32 leaf."""
    std = scale if scale is not None else shape[0] ** -0.5
    w = torch.randn((*stack, *shape), generator=gen, dtype=torch.float32, device=gen.device)
    return w.mul_(std).to(dtype)


def rope_frequencies(head_dim: int, theta: float, device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (..., S, H, hd); positions: (..., S). The head dim splits into
    halves (not interleaved pairs); computed in f32 and cast back."""
    hd = x.shape[-1]
    freqs = rope_frequencies(hd, theta, x.device)
    angles = positions[..., None].float() * freqs  # (..., S, hd/2)
    cos = torch.cos(angles)[..., None, :]  # (..., S, 1, hd/2)
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# GQA attention
# ---------------------------------------------------------------------------

def init_attention(gen: torch.Generator, cfg: ArchConfig, stack: Sequence[int] = ()) -> Params:
    d, hd = cfg.d_model, cfg.resolved_head_dim
    dt = cfg.dtype()
    return {
        "wq": _init_dense(gen, (d, cfg.num_heads * hd), dt, stack=stack),
        "wk": _init_dense(gen, (d, cfg.num_kv_heads * hd), dt, stack=stack),
        "wv": _init_dense(gen, (d, cfg.num_kv_heads * hd), dt, stack=stack),
        "wo": _init_dense(gen, (cfg.num_heads * hd, d), dt, stack=stack),
    }


def _split_heads(x: torch.Tensor, n_heads: int, hd: int) -> torch.Tensor:
    return x.reshape(*x.shape[:-1], n_heads, hd)


def _repeat_kv(kv: torch.Tensor, groups: int) -> torch.Tensor:
    """(B,S,Hkv,hd) -> (B,S,Hkv*groups,hd)."""
    if groups == 1:
        return kv
    return torch.repeat_interleave(kv, groups, dim=2)


def causal_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    q_positions: torch.Tensor,
    kv_positions: torch.Tensor,
    window: int = 0,
    kv_valid: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Masked softmax attention, GQA-native: q (B,Sq,H,hd) against the
    un-replicated k/v (B,Sk,Hkv,hd). Mask: kv_pos <= q_pos, and
    q_pos - kv_pos < window when window > 0; ``kv_valid`` (B, Sk) masks
    cache slots."""
    B, Sq, H, hd = q.shape
    Hkv = k.shape[2]
    g = H // Hkv
    scale = hd ** -0.5
    q5 = q.reshape(B, Sq, Hkv, g, hd)
    logits = torch.einsum("bqhgd,bkhd->bhgqk", q5.float(), k.float()) * scale  # (B,Hkv,g,Sq,Sk)
    mask = kv_positions[:, None, :] <= q_positions[:, :, None]  # (B,Sq,Sk)
    if window > 0:
        mask &= (q_positions[:, :, None] - kv_positions[:, None, :]) < window
    if kv_valid is not None:
        mask &= kv_valid[:, None, :].bool()
    logits = torch.where(mask[:, None, None], logits, torch.full((), _NEG, device=logits.device))
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhgqk,bkhd->bqhgd", probs.to(v.dtype), v)
    return out.reshape(B, Sq, H, v.shape[-1])


def chunked_causal_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    q_positions: torch.Tensor,
    kv_positions: torch.Tensor,
    window: int = 0,
    kv_valid: Optional[torch.Tensor] = None,
    chunk_q: int = 1024,
    chunk_k: int = 1024,
) -> torch.Tensor:
    """Flash-style attention over (chunk_q, chunk_k) blocks with an online
    softmax in f32, as JAX's ``chunked_causal_attention``: the q chunks and
    the k steps are Python loops (JAX: a loop and ``lax.scan``), and for
    aligned self-attention the k range of each q chunk skips the blocks
    wholly above the diagonal or behind the window."""
    B, Sq, H, hd = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    hd_v = v.shape[-1]
    g = H // Hkv
    cq, ck = min(chunk_q, Sq), min(chunk_k, Sk)
    if Sq % cq or Sk % ck:
        raise ValueError(f"seq lens ({Sq},{Sk}) must divide chunks ({cq},{ck})")
    nq, nk = Sq // cq, Sk // ck
    scale = hd ** -0.5
    aligned = Sq == Sk
    neg = torch.full((), _NEG, device=q.device)

    outs = []
    for iq in range(nq):
        q_lo = iq * cq
        qb = q[:, q_lo:q_lo + cq].reshape(B, cq, Hkv, g, hd).float() * scale
        qpos_b = q_positions[:, q_lo:q_lo + cq]
        if aligned:
            k_end = min(iq + 1, nk)
            k_start = max(0, (q_lo - window + 1) // ck) if window > 0 else 0
        else:
            k_start, k_end = 0, nk
        acc = torch.zeros((B, Hkv, g, cq, hd_v), dtype=torch.float32, device=q.device)
        m = torch.full((B, Hkv, g, cq), float("-inf"), dtype=torch.float32, device=q.device)
        l = torch.zeros((B, Hkv, g, cq), dtype=torch.float32, device=q.device)
        for ik in range(k_start, k_end):
            ks = slice(ik * ck, (ik + 1) * ck)
            kpos_b = kv_positions[:, ks]
            s = torch.einsum("bqhgd,bkhd->bhgqk", qb, k[:, ks].float())  # (B,Hkv,g,cq,ck)
            mask = kpos_b[:, None, None, None, :] <= qpos_b[:, None, None, :, None]
            if window > 0:
                mask &= (qpos_b[:, None, None, :, None] - kpos_b[:, None, None, None, :]) < window
            if kv_valid is not None:
                mask &= kv_valid[:, ks][:, None, None, None, :].bool()
            s = torch.where(mask, s, neg)
            m_new = torch.maximum(m, torch.amax(s, dim=-1))
            # p in the value dtype, the pv product accumulating in f32, as JAX
            p = torch.exp(s - m_new[..., None]).to(v.dtype)
            alpha = torch.exp(m - m_new)
            l = l * alpha + torch.sum(p.float(), dim=-1)
            pv = torch.einsum("bhgqk,bkhd->bhgqd", p.float(), v[:, ks].float())
            acc = acc * alpha[..., None] + pv
            m = m_new
        outs.append(acc / torch.clamp_min(l, 1e-30)[..., None])  # (B,Hkv,g,cq,hd_v)

    out = torch.stack(outs, dim=1)  # (B,nq,Hkv,g,cq,hd_v)
    out = out.permute(0, 1, 4, 2, 3, 5).reshape(B, Sq, H, hd_v)
    return out.to(v.dtype)


def _on_card(t: torch.Tensor) -> bool:
    """Whether ``t`` lies on the card (the one place the route asks)."""
    return t.is_cuda


def _use_kernels(default_positions: bool, *inputs: torch.Tensor) -> bool:
    """K7 / K8 route: the default positions, inputs on the card, nothing for
    autograd to record (the kernels have no backward) and no input wrapped
    by a ``torch.func`` transform. Inside ``grad(vmap(loss))`` every input
    reports ``requires_grad=False`` but is wrapped; torch has no public
    test for an active transform, and a tensor the transform does not wrap
    is a constant to it, which the kernels may take."""
    if not default_positions or not _on_card(inputs[0]):
        return False
    if any(torch._C._functorch.is_functorch_wrapped_tensor(t) for t in inputs):
        return False
    return not (torch.is_grad_enabled() and any(t.requires_grad for t in inputs))


def _full_attention(q, k, v, cfg: ArchConfig, positions, *, window: int = 0, default_positions: bool = False):
    """K7 on the card for the default positions when autograd records
    nothing; else the layer code: naive for short sequences, chunked for
    long."""
    if _use_kernels(default_positions, q, k, v):
        return _fa.attention(q, k, v, causal=True, window=window)
    S = q.shape[1]
    if cfg.attn_chunk and S > cfg.attn_chunk:
        return chunked_causal_attention(
            q, k, v, q_positions=positions, kv_positions=positions,
            window=window, chunk_q=cfg.attn_chunk, chunk_k=cfg.attn_chunk,
        )
    return causal_attention(q, k, v, q_positions=positions, kv_positions=positions, window=window)


def attention_qkv(params: Params, x: torch.Tensor, cfg: ArchConfig, positions: torch.Tensor):
    """The roped q (B,S,H,hd) and k (B,S,Hkv,hd), and v (B,S,Hkv,hd)."""
    hd = cfg.resolved_head_dim
    q = _split_heads(x @ params["wq"], cfg.num_heads, hd)
    k = _split_heads(x @ params["wk"], cfg.num_kv_heads, hd)
    v = _split_heads(x @ params["wv"], cfg.num_kv_heads, hd)
    return apply_rope(q, positions, cfg.rope_theta), apply_rope(k, positions, cfg.rope_theta), v


def attention_with_kv(params: Params, x: torch.Tensor, cfg: ArchConfig, positions: torch.Tensor, *,
                      window: int = 0, default_positions: bool = False):
    """Self-attention over the full sequence (training / prefill), with the
    roped k and the v (B,S,Hkv,hd) that the prefill writes to its cache.
    ``default_positions`` says that ``positions`` is ``arange(S)`` for every
    row (the caller built it so), which lets K7 take the call."""
    B, S, _ = x.shape
    q, k, v = attention_qkv(params, x, cfg, positions)
    out = _full_attention(q, k, v, cfg, positions, window=window, default_positions=default_positions)
    return out.reshape(B, S, -1) @ params["wo"], k, v


def init_kv_cache(cfg: ArchConfig, batch: int, max_len: int, dtype, device=None, stack: Sequence[int] = ()) -> Params:
    hd = cfg.resolved_head_dim
    cache_len = min(max_len, cfg.window) if cfg.window > 0 else max_len
    return {
        "k": torch.zeros((*stack, batch, cache_len, cfg.num_kv_heads, hd), dtype=dtype, device=device),
        "v": torch.zeros((*stack, batch, cache_len, cfg.num_kv_heads, hd), dtype=dtype, device=device),
        # absolute position stored in each slot (-1 = empty), for ring buffers
        "pos": torch.full((*stack, batch, cache_len), -1, dtype=torch.int32, device=device),
    }


def attention_decode(
    params: Params,
    x: torch.Tensor,
    cache: Params,
    cfg: ArchConfig,
    position: torch.Tensor,
    *,
    window: int = 0,
) -> Tuple[torch.Tensor, Params]:
    """Single-token decode with a (ring-buffered, if windowed) KV cache.
    x: (B, 1, d); position: (B,) absolute position of the new token. Always
    the layer code: one query against cache slots masked by ``pos >= 0``."""
    B = x.shape[0]
    cache_len = cache["k"].shape[1]
    q, k_new, v_new = attention_qkv(params, x, cfg, position[:, None])
    slot = torch.remainder(position, cache_len)  # ring for windowed, linear otherwise
    hit = torch.arange(cache_len, device=x.device)[None, :] == slot[:, None]  # (B, L)
    k = torch.where(hit[..., None, None], k_new.to(cache["k"].dtype), cache["k"])
    v = torch.where(hit[..., None, None], v_new.to(cache["v"].dtype), cache["v"])
    pos_buf = torch.where(hit, position[:, None].to(torch.int32), cache["pos"])
    out = causal_attention(q, k, v, q_positions=position[:, None], kv_positions=pos_buf, window=window,
                           kv_valid=pos_buf >= 0)
    y = out.reshape(B, 1, -1) @ params["wo"]
    return y, {"k": k, "v": v, "pos": pos_buf}


# ---------------------------------------------------------------------------
# MLPs
# ---------------------------------------------------------------------------

def init_mlp(gen: torch.Generator, d: int, ff: int, dtype, stack: Sequence[int] = ()) -> Params:
    return {
        "w1": _init_dense(gen, (d, ff), dtype, stack=stack),
        "w3": _init_dense(gen, (d, ff), dtype, stack=stack),
        "w2": _init_dense(gen, (ff, d), dtype, stack=stack),
    }


def mlp_apply(params: Params, x: torch.Tensor) -> torch.Tensor:
    h = F.silu(x @ params["w1"]) * (x @ params["w3"])
    return h @ params["w2"]
