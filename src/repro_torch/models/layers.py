"""Transformer layers for the LM stack, the counterpart of ``repro.models.layers``.

RMSNorm, RoPE, GQA/MQA attention (full-causal and sliding-window, the
full-sequence path and the cached single-token decode), DeepSeek-V3's
multi-head latent attention (MLA: the full-sequence path, its latent cache
and the absorbed-matrix decode), the SwiGLU MLP and the sort-based
fixed-capacity MoE, over plain dictionaries of tensors with the JAX
package's names, shapes and layouts.

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

MLA's full-sequence attention takes the same two routes. Its v head dim
(``v_head_dim``) is narrower than its q/k head dim (nope + rope), and K7
wants k and v of one shape, so the K7 route pads v with zero columns to
the q/k head dim and slices the output back: zero columns of V give zero
columns of the output, so it is the same function.

Under a hint mesh whose "model" axis is larger than 1
(``dist.sharding.hint_model_mesh``) every layer runs on the rank's slices,
as Megatron splits them: the head counts come from the weights' widths
(H / M query heads, and Hkv / M KV heads or the one its query heads read),
the column-parallel products take their input through
``sharding.model_copy`` and the row-parallel ones give their output
through ``row_parallel`` (the partial products summed over the ranks in
f32 and rounded once, as one device's product rounds); K7 takes the
rank's heads in a prefill. MLA keeps its latent whole on every rank (the
copy sits on the latent, where it meets the rank's heads in ``wq_b`` and
``wkv_b``); the MoE routes the whole ``x`` identically on every rank, so
its drops are one device's, and runs the experts on the rank's f
columns: the dispatch reads ``model_copy(x)``, the gates reach the
combine through ``model_copy``, and the combined (T, d) f32 output is
summed once. Off such a mesh those are the identity.

The MoE is JAX's single-device dispatch (one token group, exchange mode
``"none"``): a stable argsort of the (token, k) assignments by expert
gives each its rank, assignments of rank C or more are dropped, and the
experts run as batched products over fixed (E, C, d) buffers. Every step
is out of place and has a ``torch.func`` batching rule (no ``bincount``,
no in-place ``index_put_``), so the engine's ``grad(vmap(loss))`` batches
it without a per-client loop. The expert products stay plain
``torch.bmm``: JAX computes them with einsum outside any Pallas kernel.

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

from repro_torch.analysis import opcount
from repro_torch.configs.base import ArchConfig
from repro_torch.dist import sharding
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


def _split_heads(x: torch.Tensor, hd: int) -> torch.Tensor:
    """(..., n hd) -> (..., n, hd): as many heads as the product's width holds."""
    return x.reshape(*x.shape[:-1], -1, hd)


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


def _matmul_f32(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``a @ w`` in f32 with nothing rounded before the result (JAX's
    ``preferred_element_type=float32``): a 2-D ``w`` after ``a``'s last
    dim, or experts' (E,C,d) @ (E,d,f). bf16 on the card takes the
    product's f32 output (``mm`` / ``bmm`` ``out_dtype``) where autograd
    records nothing and no ``torch.func`` transform wraps an input: torch
    has no derivative and no batching rule for that output. Elsewhere the
    operands are upcast (exact for bf16 values), an expert product's in
    blocks of experts, so the whole expert weight is never held in f32."""
    if a.dtype == torch.float32 and w.dtype == torch.float32:
        return a @ w
    if _on_card(a) and not _transformed(a, w) and not (
            torch.is_grad_enabled() and (a.requires_grad or w.requires_grad)):
        if w.dim() == 3:
            return torch.bmm(a, w, out_dtype=torch.float32)
        out = torch.mm(a.reshape(-1, a.shape[-1]), w, out_dtype=torch.float32)
        return out.reshape(*a.shape[:-1], w.shape[-1])
    return _expert_matmul_upcast(a, w) if w.dim() == 3 else a.float() @ w.float()


def row_parallel(h: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``h @ w`` for a row-parallel ``w`` (its rows split over the model
    ranks, ``h`` the rank's matching columns): off a model axis the
    product itself; on a model rank the partial products summed over the
    ranks (``sharding.model_reduce``), taken and summed in f32 for a
    narrower dtype and rounded once to ``h``'s dtype, as one device's
    product accumulates in f32 and rounds once."""
    if sharding.hint_model_mesh() is None:
        return h @ w
    if h.dtype == torch.float32:
        return sharding.model_reduce(h @ w)
    with opcount.bf16_payload():  # the sum's f32 payload: a bf16 program's would be half
        return sharding.model_reduce(_matmul_f32(h, w)).to(h.dtype)


def _on_card(t: torch.Tensor) -> bool:
    """Whether ``t`` lies on the card (the one place the route asks). The
    dry run's meta tensors stand for the card's while its counter is
    active (``analysis.opcount.is_fake``), so its counts follow the card's
    route."""
    return t.is_cuda or (t.is_meta and opcount.is_fake(t))


def _transformed(*inputs: torch.Tensor) -> bool:
    """Whether a ``torch.func`` transform wraps any of ``inputs``. Inside
    ``grad(vmap(loss))`` every input reports ``requires_grad=False`` but is
    wrapped; torch has no public test for an active transform, and a
    tensor the transform does not wrap is a constant to it."""
    return any(torch._C._functorch.is_functorch_wrapped_tensor(t) for t in inputs)


def _use_kernels(default_positions: bool, *inputs: torch.Tensor) -> bool:
    """K7 / K8 route: the default positions, inputs on the card, nothing for
    autograd to record (the kernels have no backward) and no input wrapped
    by a ``torch.func`` transform (``_transformed``)."""
    if not default_positions or not _on_card(inputs[0]) or _transformed(*inputs):
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
    """The roped q (B,S,H,hd) and k (B,S,Hkv,hd), and v (B,S,Hkv,hd); on a
    model rank its H / M query heads and its KV heads."""
    hd = cfg.resolved_head_dim
    x = sharding.model_copy(x)
    q = _split_heads(x @ params["wq"], hd)
    k = _split_heads(x @ sharding.model_kv(params["wk"], cfg.num_kv_heads), hd)
    v = _split_heads(x @ sharding.model_kv(params["wv"], cfg.num_kv_heads), hd)
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
    return row_parallel(out.reshape(B, S, -1), params["wo"]), k, v


def init_kv_cache(cfg: ArchConfig, batch: int, max_len: int, dtype, device=None, stack: Sequence[int] = ()) -> Params:
    """Empty k / v / slot-position buffers for the KV heads this rank holds."""
    hd = cfg.resolved_head_dim
    hkv = sharding.model_kv_heads(cfg.num_kv_heads)
    cache_len = min(max_len, cfg.window) if cfg.window > 0 else max_len
    return {
        "k": torch.zeros((*stack, batch, cache_len, hkv, hd), dtype=dtype, device=device),
        "v": torch.zeros((*stack, batch, cache_len, hkv, hd), dtype=dtype, device=device),
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
    y = row_parallel(out.reshape(B, 1, -1), params["wo"])
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
    """SwiGLU; on a model rank over its d_ff / M columns, summed after ``w2``."""
    x = sharding.model_copy(x)
    h = F.silu(x @ params["w1"]) * (x @ params["w3"])
    return row_parallel(h, params["w2"])


# ---------------------------------------------------------------------------
# MLA (DeepSeek-V3 multi-head latent attention)
# ---------------------------------------------------------------------------

def init_mla(gen: torch.Generator, cfg: ArchConfig, stack: Sequence[int] = ()) -> Params:
    m = cfg.mla
    d, H = cfg.d_model, cfg.num_heads
    dt = cfg.dtype()
    qk_head = m.qk_nope_head_dim + m.qk_rope_head_dim
    return {
        "wq_a": _init_dense(gen, (d, m.q_lora_rank), dt, stack=stack),
        "q_norm": init_rmsnorm(m.q_lora_rank, dt, gen.device, stack),
        "wq_b": _init_dense(gen, (m.q_lora_rank, H * qk_head), dt, stack=stack),
        "wkv_a": _init_dense(gen, (d, m.kv_lora_rank + m.qk_rope_head_dim), dt, stack=stack),
        "kv_norm": init_rmsnorm(m.kv_lora_rank, dt, gen.device, stack),
        "wkv_b": _init_dense(gen, (m.kv_lora_rank, H * (m.qk_nope_head_dim + m.v_head_dim)), dt, stack=stack),
        "wo": _init_dense(gen, (H * m.v_head_dim, d), dt, stack=stack),
    }


def _mla_query(params: Params, x: torch.Tensor, cfg: ArchConfig, positions: torch.Tensor):
    """(q_nope (B,S,H,dn), roped q_rope (B,S,H,dr)); on a model rank its
    H / M heads, from the whole query latent."""
    m = cfg.mla
    B, S, _ = x.shape
    dn = m.qk_nope_head_dim
    c_q = rmsnorm(x @ params["wq_a"], params["q_norm"], cfg.norm_eps)
    q = sharding.model_copy(c_q) @ params["wq_b"]
    q = q.reshape(B, S, -1, dn + m.qk_rope_head_dim)
    return q[..., :dn], apply_rope(q[..., dn:], positions, cfg.rope_theta)


def mla_latent(params: Params, x: torch.Tensor, cfg: ArchConfig, positions: torch.Tensor):
    """What the decode cache keeps per token: the normed latent c_kv
    (B,S,kv_lora_rank) and the roped shared key k_rope (B,S,dr)."""
    L = cfg.mla.kv_lora_rank
    kv = x @ params["wkv_a"]
    c_kv = rmsnorm(kv[..., :L], params["kv_norm"], cfg.norm_eps)
    k_rope = apply_rope(kv[..., None, L:], positions, cfg.rope_theta)[:, :, 0]
    return c_kv, k_rope


def mla_qkv(params: Params, x: torch.Tensor, cfg: ArchConfig, positions: torch.Tensor):
    """The full-sequence MLA's attention inputs: q and k (B,S,H,dn+dr), v
    (B,S,H,dv), and the latent (c_kv, k_rope) they were built from (whole
    on every model rank; q, k and v its H / M heads)."""
    m = cfg.mla
    B, S, _ = x.shape
    dn, dr = m.qk_nope_head_dim, m.qk_rope_head_dim
    q_nope, q_rope = _mla_query(params, x, cfg, positions)
    c_kv, k_rope = mla_latent(params, x, cfg, positions)
    kvu = (sharding.model_copy(c_kv) @ params["wkv_b"]).reshape(B, S, -1, dn + m.v_head_dim)
    H = kvu.shape[2]
    k = torch.cat([kvu[..., :dn], sharding.model_copy(k_rope)[:, :, None].expand(B, S, H, dr)], dim=-1)
    return torch.cat([q_nope, q_rope], dim=-1), k, kvu[..., dn:], c_kv, k_rope


def mla_attention(q, k, v, cfg: ArchConfig, positions, *, default_positions: bool = False) -> torch.Tensor:
    """Causal attention with v narrower than q and k: K7 on v zero-padded to
    the q/k head dim (the output sliced back) where ``_use_kernels`` says
    so, else the layer code (``_full_attention``)."""
    if _use_kernels(default_positions, q, k, v):
        pad = q.shape[-1] - v.shape[-1]
        return _fa.attention(q, k, F.pad(v, (0, pad)), causal=True)[..., :v.shape[-1]]
    return _full_attention(q, k, v, cfg, positions)


def mla_with_latent(params: Params, x: torch.Tensor, cfg: ArchConfig, positions: torch.Tensor, *,
                    default_positions: bool = False):
    """Full-sequence MLA (training / prefill): (y (B,S,d), c_kv, k_rope),
    the latent being what the prefill writes to its cache."""
    B, S, _ = x.shape
    q, k, v, c_kv, k_rope = mla_qkv(params, x, cfg, positions)
    out = mla_attention(q, k, v, cfg, positions, default_positions=default_positions)
    return row_parallel(out.reshape(B, S, -1), params["wo"]), c_kv, k_rope


def init_mla_cache(cfg: ArchConfig, batch: int, max_len: int, dtype, device=None, stack: Sequence[int] = ()) -> Params:
    m = cfg.mla
    return {
        "c_kv": torch.zeros((*stack, batch, max_len, m.kv_lora_rank), dtype=dtype, device=device),
        "k_rope": torch.zeros((*stack, batch, max_len, m.qk_rope_head_dim), dtype=dtype, device=device),
        "pos": torch.full((*stack, batch, max_len), -1, dtype=torch.int32, device=device),
    }


def mla_decode(params: Params, x: torch.Tensor, cache: Params, cfg: ArchConfig,
               position: torch.Tensor) -> Tuple[torch.Tensor, Params]:
    """Absorbed-matrix MLA decode in f32 over the latent cache: q_nope goes
    through W_uk^T into the latent space, so the scores and the context
    read only (kv_lora_rank + rope) numbers per cached token. x: (B,1,d);
    position: (B,) absolute position of the new token (its cache slot). On
    a model rank the cache is whole and the heads are the rank's."""
    m = cfg.mla
    B = x.shape[0]
    dn, dr, dv, L = m.qk_nope_head_dim, m.qk_rope_head_dim, m.v_head_dim, m.kv_lora_rank
    H = params["wkv_b"].shape[-1] // (dn + dv)
    q_nope, q_rope = _mla_query(params, x, cfg, position[:, None])
    c_new, kr_new = mla_latent(params, x, cfg, position[:, None])
    hit = torch.arange(cache["c_kv"].shape[1], device=x.device)[None, :] == position[:, None]  # (B, max_len)
    c_kv = torch.where(hit[..., None], c_new.to(cache["c_kv"].dtype), cache["c_kv"])
    k_rope = torch.where(hit[..., None], kr_new.to(cache["k_rope"].dtype), cache["k_rope"])
    pos_buf = torch.where(hit, position[:, None].to(torch.int32), cache["pos"])

    wkv_b = params["wkv_b"].reshape(L, H, dn + dv)
    w_uk, w_uv = wkv_b[..., :dn].float(), wkv_b[..., dn:].float()
    c32 = sharding.model_copy(c_kv).float()
    q_lat = torch.einsum("bqhn,lhn->bqhl", q_nope.float(), w_uk)
    scores = torch.einsum("bqhl,bsl->bhqs", q_lat, c32)
    scores = scores + torch.einsum("bqhr,bsr->bhqs", q_rope.float(), sharding.model_copy(k_rope).float())
    scores = scores * (dn + dr) ** -0.5
    valid = (pos_buf >= 0) & (pos_buf <= position[:, None])
    scores = torch.where(valid[:, None, None, :], scores, torch.full((), _NEG, device=x.device))
    probs = torch.softmax(scores, dim=-1)
    ctx = torch.einsum("bhqs,bsl->bqhl", probs, c32)  # the latent context
    out = torch.einsum("bqhl,lhv->bqhv", ctx, w_uv).to(x.dtype)
    y = row_parallel(out.reshape(B, 1, H * dv), params["wo"])
    return y, {"c_kv": c_kv, "k_rope": k_rope, "pos": pos_buf}


# ---------------------------------------------------------------------------
# MoE: sort-based fixed-capacity dispatch
# ---------------------------------------------------------------------------

_UPCAST_ELEMENTS = 1 << 26  # f32 elements of expert weights upcast at a time (256 MiB)


def init_moe(gen: torch.Generator, cfg: ArchConfig, stack: Sequence[int] = ()) -> Params:
    m = cfg.moe
    d, E, f = cfg.d_model, m.num_experts, m.d_ff_expert
    dt = cfg.dtype()
    params = {
        "router": _init_dense(gen, (d, E), torch.float32, scale=d ** -0.5, stack=stack),
        "w1": _init_dense(gen, (E, d, f), dt, stack=stack),
        "w3": _init_dense(gen, (E, d, f), dt, stack=stack),
        "w2": _init_dense(gen, (E, f, d), dt, stack=stack),
    }
    if m.num_shared_experts:
        params["shared"] = init_mlp(gen, d, m.num_shared_experts * f, dt, stack)
    if m.dense_residual:
        params["dense"] = init_mlp(gen, d, cfg.d_ff, dt, stack)
    return params


def moe_capacity(num_tokens: int, cfg: ArchConfig) -> int:
    """Slots per expert: tokens x top_k x capacity_factor / experts, plus
    one, rounded up to a multiple of 8 (at least 8)."""
    m = cfg.moe
    cap = int(num_tokens * m.top_k * m.capacity_factor / m.num_experts) + 1
    return max(8, -(-cap // 8) * 8)


def _expert_matmul_upcast(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``_matmul_f32`` of experts with blocks of experts upcast to f32."""
    step = max(1, _UPCAST_ELEMENTS // max(1, w[0].numel()))
    return torch.cat([torch.bmm(a[i:i + step].float(), w[i:i + step].float()) for i in range(0, w.shape[0], step)])


def moe_route(router: torch.Tensor, x: torch.Tensor, top_k: int):
    """(probs (T,E) f32, gates (T,K) renormalised, ids (T,K)): softmax of
    the f32 router logits and its top k (``torch.topk``; ties, which random
    f32 inputs do not produce, may order otherwise than ``lax.top_k``)."""
    probs = torch.softmax(x.float() @ router, dim=-1)
    gates, ids = torch.topk(probs, top_k, dim=-1)
    return probs, gates / torch.sum(gates, dim=-1, keepdim=True), ids


def moe_ranks(flat_e: torch.Tensor, num_experts: int):
    """(counts (E,), starts (E,), ranks (T*K,), order): how many assignments
    each expert got, where its run begins in the sorted order, each
    assignment's rank among its expert's in token order (a stable argsort,
    then the offset from its expert's start), and the sort order itself."""
    n = flat_e.shape[0]
    order = torch.argsort(flat_e, stable=True)
    counts = torch.sum(flat_e[:, None] == torch.arange(num_experts, device=flat_e.device), dim=0)
    starts = torch.cumsum(counts, dim=0) - counts
    ranks_sorted = torch.arange(n, device=flat_e.device) - starts[flat_e[order]]
    ranks = torch.zeros_like(ranks_sorted).scatter(0, order, ranks_sorted)
    return counts, starts, ranks, order


def _moe_dispatch(xg: torch.Tensor, ids: torch.Tensor, num_experts: int, capacity: int):
    """One token group's fixed-capacity dispatch: (buf (E, C, d), flat expert
    ids (Tg*K,), each assignment's rank among its expert's, counts (E,)).
    Slot (e, c) gathers the token of the c-th assignment in expert e's
    sorted run (out of place); ranks C and beyond are dropped."""
    tg, k = ids.shape
    flat_e = ids.reshape(-1)
    counts, starts, ranks, order = moe_ranks(flat_e, num_experts)
    slot_c = torch.arange(capacity, device=xg.device)
    src = torch.clamp(starts[:, None] + slot_c[None, :], max=tg * k - 1)  # (E, C) positions in sorted order
    filled = slot_c[None, :] < counts[:, None]
    zero = torch.zeros((), dtype=xg.dtype, device=xg.device)
    return torch.where(filled[..., None], xg[order[src] // k], zero), flat_e, ranks, counts


def moe_combine(out_ec: torch.Tensor, flat_e: torch.Tensor, ranks: torch.Tensor, gates: torch.Tensor):
    """One group's gated combine: each assignment reads its slot of the
    (E, C, d) expert outputs (0 past the capacity, JAX's ``mode="fill"``)
    and the top-k are summed in f32 with their gates -> (Tg, d) f32."""
    e, c, d = out_ec.shape
    tg, k = gates.shape
    kept = ranks < c
    slot = flat_e * c + torch.clamp(ranks, max=c - 1)
    zero = torch.zeros((), dtype=out_ec.dtype, device=out_ec.device)
    gathered = torch.where(kept[:, None], out_ec.reshape(e * c, d)[slot], zero)
    return torch.sum(gathered.reshape(tg, k, d).float() * gates[..., None], dim=1)


def moe_apply(params: Params, x: torch.Tensor, cfg: ArchConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (T, d) tokens. Returns (y (T,d), the Switch load-balance aux loss).

    The tokens split into G groups (the hint mesh's data-axis size,
    ``dist.sharding.hint_data_groups``; 1 off-mesh, and 1 when G does not
    divide T), each with its own capacity ``moe_capacity(T // G)``, as
    JAX's. Each group's top-k assignments go to fixed (E, C, d) buffers at
    the slot of their rank (``_moe_dispatch``); the expert SwiGLU runs
    over the (E, G*C, d) expert-major buffer, computes h and g in f32 and
    rounds after ``silu(h) * g``; each group's gated combine and the shared
    / dense branches add in f32.

    Under an "ep_data" hint mesh (``moe_ep_mode``) with this rank holding
    E/P experts' rows (``dist.sharding.expert_rows``), ``x`` is this rank's
    tokens, one group: the buffers go to the experts' ranks and back by one
    all-to-all each way (``moe_dispatch_exchange`` /
    ``moe_combine_exchange``), and the aux loss takes the router statistics
    of every group from one all-reduce over the data axis. A rank that
    holds all E experts dispatches its G groups locally (what JAX's
    exchange computes, to 0.0). The exchange is a collective outside
    autograd: serving runs it, training (whole client models a rank) does
    not.

    On a model rank (``sharding.hint_model_mesh``) the experts hold their
    f / M columns (``w1`` / ``w3``, ``w2``'s rows) and the routing runs on
    the whole ``x``, as on one device: the dispatch reads
    ``model_copy(x)``, the gates reach the combine through ``model_copy``,
    each rank's expert outputs stay f32 (nothing rounded before the sum)
    and the combined (T, d) f32 output is summed over the ranks once."""
    m = cfg.moe
    T, d = x.shape
    E, K = m.num_experts, m.top_k
    e_local = params["w1"].shape[-3]
    mode = sharding.moe_ep_mode(E)
    groups = sharding.hint_data_groups()
    ep = mode == "ep_data" and e_local != E
    if ep:
        if e_local * groups != E:
            raise ValueError(f"this rank holds {e_local} of {E} experts; the expert-parallel exchange over a "
                             f"data axis of {groups} needs {E // groups}")
        G, G_local, Tg = groups, 1, T
    else:
        if e_local != E:
            raise ValueError(f"the MoE holds {e_local} of {E} experts but no expert-parallel hint mesh is installed")
        G = groups if T % groups == 0 else 1
        G_local, Tg = G, T // G
    C = moe_capacity(Tg, cfg)

    tp = sharding.hint_model_mesh() is not None
    probs, gates, ids = moe_route(params["router"], x, K)
    xd = sharding.model_copy(x)
    parts = [_moe_dispatch(xd[g * Tg:(g + 1) * Tg], ids[g * Tg:(g + 1) * Tg], E, C) for g in range(G_local)]
    buf_g = torch.stack([p[0] for p in parts])  # (G_local, E, C, d)
    if ep:
        buf = sharding.moe_dispatch_exchange(buf_g, mode)  # (E/P, G*C, d)
    else:
        buf = buf_g.transpose(0, 1).reshape(E, G * C, d)

    h = _matmul_f32(buf, params["w1"])
    g = _matmul_f32(buf, params["w3"])
    act = (F.silu(h) * g).to(x.dtype)
    out_buf = _matmul_f32(act, params["w2"]) if tp else torch.bmm(act, params["w2"]).to(x.dtype)

    gates_g = sharding.model_copy(gates).reshape(G_local, Tg, K)
    if ep:
        yg = sharding.moe_combine_exchange(out_buf, [p[1] for p in parts], [p[2] for p in parts], gates_g, mode, C)
    else:
        out_g = out_buf.reshape(E, G, C, d).transpose(0, 1)  # (G, E, C, d)
        yg = torch.stack([moe_combine(out_g[i], parts[i][1], parts[i][2], gates_g[i]) for i in range(G)])
    y = sharding.model_reduce(yg.reshape(T, d))
    if "shared" in params:
        y = y + mlp_apply(params["shared"], x).float()
    if "dense" in params:
        y = y + mlp_apply(params["dense"], x).float()

    counts = parts[0][3] if G_local == 1 else sum(p[3] for p in parts)
    if ep:
        # every group's router statistics: counts and summed probs, one all-reduce
        stats = sharding.all_reduce_sum(torch.cat([counts.float(), torch.sum(probs, dim=0)]),
                                        sharding.hint_mesh(), "moe_aux_all_reduce", axis="data")
        t_all = T * groups
        frac_tokens = stats[:E] / (t_all * K) * K
        mean_probs = stats[E:] / t_all
    else:
        frac_tokens = counts.float() / (T * K) * K
        mean_probs = torch.mean(probs, dim=0)
    aux = m.router_aux_weight * E * torch.sum(frac_tokens * mean_probs)
    return y.to(x.dtype), aux
