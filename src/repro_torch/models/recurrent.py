"""The recurrent blocks, the counterpart of ``repro.models.recurrent``: the
RG-LRU (Griffin / RecurrentGemma temporal mixing) and xLSTM's mLSTM
(matrix memory, stabilised chunkwise form) and sLSTM (scalar memory with
hidden-dependent gates).

    init_rglru(gen, cfg)                      -> params
    rglru_sequence(params, x, cfg)            -> (y, h_S, u)  (full sequence)
    rglru_init_state(cfg, batch, dtype)       -> state        (O(1) decode state)
    rglru_step(params, x_t, state, cfg)       -> (y_t, state)

and the same four for ``mlstm`` and ``slstm``, whose ``*_sequence`` return
(y, the decode state after the last position).

The recurrence h_t = a_t * h_{t-1} + b_t (h_0 = 0) over the sequence has two
routes, as attention has in ``layers`` (``layers._use_kernels``): K8
(``kernels.rglru_scan``) on CUDA tensors that neither autograd nor a
``torch.func`` transform would record, and otherwise ``_associative_scan``,
a log-step scan that mirrors JAX's ``jax.lax.associative_scan``.

The mLSTM and sLSTM run plain PyTorch on every device, in f32 as JAX's
``jnp`` code does (JAX has no Pallas kernel for them): the mLSTM as a
Python loop over chunks of ``cfg.mlstm_chunk`` (JAX: ``lax.scan``), the
sLSTM as a Python loop over time steps (no parallel form exists: its
gates read h_{t-1}).

Under a hint mesh whose "model" axis is larger than 1 each block runs on
the rank's slices (``dist.sharding._role``) and takes its widths from
them: the RG-LRU on its dr / M channels (its input through
``sharding.model_copy``, the convolution, the coefficients and the scan
per channel, K8 on the rank's (B, S, dr / M)); the mLSTM and the sLSTM on
their H / M heads (the mLSTM's ``u`` from the whole ``w_up`` meets the
rank's ``wq`` / ``wk`` / ``wv`` and gate columns through one copy, the
block input meets ``w_gate`` through another; the sLSTM's recurrence is
block-diagonal by head, so its loop over time holds no collective). Each
gives its output through ``layers.row_parallel``. The decode states are
the rank's channels or heads, sized from the weights.
"""
from __future__ import annotations

from typing import Dict, Sequence, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels import rglru_scan as _rg
from repro_torch.dist import sharding
from repro_torch.models.layers import _init_dense, _use_kernels, row_parallel

Params = Dict[str, torch.Tensor]
_RGLRU_C = 8.0


def init_rglru(gen: torch.Generator, cfg: ArchConfig, stack: Sequence[int] = ()) -> Params:
    d, dr = cfg.d_model, cfg.d_rnn_resolved
    dt = cfg.dtype()
    # Lambda init so that a = exp(-c*softplus(L)*sigma(..)) sits in (0.9, 0.999)
    lam = torch.rand((*stack, dr), generator=gen, dtype=torch.float32, device=gen.device) * 0.5 + 0.3
    return {
        "w_x": _init_dense(gen, (d, dr), dt, stack=stack),
        "w_gate": _init_dense(gen, (d, dr), dt, stack=stack),
        "conv": _init_dense(gen, (4, dr), dt, scale=0.5, stack=stack),
        "a_r": _init_dense(gen, (dr,), torch.float32, scale=1.0, stack=stack),
        "a_i": _init_dense(gen, (dr,), torch.float32, scale=1.0, stack=stack),
        "lambda": lam,
        "w_out": _init_dense(gen, (dr, d), dt, stack=stack),
    }


def _rglru_coeffs(params: Params, v: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-step recurrence coefficients. v: (..., dr) conv output.

    log a_t = -c * softplus(Lambda) * sigmoid(a_r * v_t)
    b_t     = sqrt(1 - a_t^2) * sigmoid(a_i * v_t) * v_t
    """
    vf = v.float()
    r = torch.sigmoid(params["a_r"] * vf)
    i = torch.sigmoid(params["a_i"] * vf)
    log_a = -_RGLRU_C * F.softplus(params["lambda"]) * r
    a = torch.exp(log_a)
    b = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), 0.0, 1.0)) * i * vf
    return a, b


def _conv1d_causal(x: torch.Tensor, kernel: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv, width 4. x: (B,S,dr), kernel: (4,dr)."""
    pad = F.pad(x, (0, 0, 3, 0))
    return sum(pad[:, i:i + x.shape[1]] * kernel[i] for i in range(4))


def _associative_scan(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """h_t = a_t * h_{t-1} + b_t from h_0 = 0 over dim 1, by the combine
    (a1, b1), (a2, b2) -> (a1 a2, a2 b1 + b2) in ceil(log2 S) doubling steps
    (Hillis-Steele), the operator of JAX's ``associative_scan`` (whose
    recursion pairs the terms in another order)."""
    S = a.shape[1]
    shift = 1
    while shift < S:
        a_prev, b_prev = a[:, :-shift], b[:, :-shift]
        b = torch.cat([b[:, :shift], a[:, shift:] * b_prev + b[:, shift:]], dim=1)
        a = torch.cat([a[:, :shift], a[:, shift:] * a_prev], dim=1)
        shift *= 2
    return b


def rglru_sequence(params: Params, x: torch.Tensor, cfg: ArchConfig, *, default_positions: bool = False):
    """The full-sequence block and what a decode cache needs:
    (y (B,S,d), h_S (B,dr) f32, u = x @ w_x (B,S,dr)). K8 takes the scan on
    the card when autograd records nothing (``default_positions``: the
    sequence starts at position 0, so h_0 = 0). On a model rank dr is its
    channels."""
    x = sharding.model_copy(x)
    gate = F.gelu((x @ params["w_gate"]).float(), approximate="tanh")
    u = x @ params["w_x"]
    v = _conv1d_causal(u, params["conv"])
    a, b = _rglru_coeffs(params, v)
    if _use_kernels(default_positions, a, b):
        h, h_last = _rg.rglru_scan(a, b, torch.zeros_like(a[:, 0]))
    else:
        h = _associative_scan(a, b)
        h_last = h[:, -1]
    y = row_parallel((h * gate).to(x.dtype), params["w_out"])
    return y, h_last, u


def rglru_init_state(cfg: ArchConfig, batch: int, dtype, device=None, stack: Sequence[int] = (),
                     params: Params = None) -> Params:
    """The zero state; its width ``params``' channels where given (a model
    rank's), else ``cfg``'s."""
    dr = cfg.d_rnn_resolved if params is None else params["w_x"].shape[-1]
    return {
        "h": torch.zeros((*stack, batch, dr), dtype=torch.float32, device=device),
        "conv": torch.zeros((*stack, batch, 3, dr), dtype=dtype, device=device),  # last 3 pre-conv inputs
    }


def rglru_step(params: Params, x_t: torch.Tensor, state: Params, cfg: ArchConfig):
    """x_t: (B,1,d) -> (y_t, state). Always the layer code."""
    xt = sharding.model_copy(x_t[:, 0])
    gate = F.gelu((xt @ params["w_gate"]).float(), approximate="tanh")
    u = xt @ params["w_x"]  # (B, dr)
    window = torch.cat([state["conv"], u[:, None]], dim=1)  # (B,4,dr)
    v = sum(window[:, i] * params["conv"][i] for i in range(4))
    a, b = _rglru_coeffs(params, v)
    h = a * state["h"] + b
    y = row_parallel((h * gate).to(x_t.dtype), params["w_out"])[:, None]
    return y, {"h": h, "conv": window[:, 1:]}


# ---------------------------------------------------------------------------
# mLSTM (xLSTM matrix-memory cell), stabilised chunkwise form
# ---------------------------------------------------------------------------

_M0 = -1e30  # the stabiliser's start: exp(m0 + ...) underflows to 0


def init_mlstm(gen: torch.Generator, cfg: ArchConfig, stack: Sequence[int] = ()) -> Params:
    d = cfg.d_model
    up = 2 * d
    dt = cfg.dtype()
    return {
        "w_up": _init_dense(gen, (d, up), dt, stack=stack),
        "w_gate": _init_dense(gen, (d, up), dt, stack=stack),
        "wq": _init_dense(gen, (up, up), dt, stack=stack),
        "wk": _init_dense(gen, (up, up), dt, stack=stack),
        "wv": _init_dense(gen, (up, up), dt, stack=stack),
        "a_i": _init_dense(gen, (up,), torch.float32, scale=1.0, stack=stack),
        "a_f": _init_dense(gen, (up,), torch.float32, scale=1.0, stack=stack),
        "w_down": _init_dense(gen, (up, d), dt, stack=stack),
    }


def _mlstm_dh(cfg: ArchConfig) -> int:
    return 2 * cfg.d_model // max(cfg.num_heads, 1)


def _mlstm_qkv_gates(params: Params, x: torch.Tensor, cfg: ArchConfig):
    """x: (B,S,d) -> q, k, v (B,S,H,dh); i, f gate logits (B,S,H) and the
    output gate (B,S,H dh), f32. On a model rank H is its heads, and the
    gate logits read its heads' columns of the whole ``u``."""
    u = x @ params["w_up"]
    B, S, _ = u.shape
    dh = _mlstm_dh(cfg)
    H = params["wq"].shape[-1] // dh
    uc = sharding.model_copy(u)
    heads = lambda t: t.reshape(B, S, H, dh)
    q = heads(uc @ params["wq"]) * dh ** -0.5
    k = heads(uc @ params["wk"])
    v = heads(uc @ params["wv"])
    off = sharding.model_offset(H * dh)
    uf = uc[..., off:off + H * dh].float()
    i_logit = (uf * params["a_i"]).reshape(B, S, H, dh).mean(-1)
    f_logit = (uf * params["a_f"]).reshape(B, S, H, dh).mean(-1) + 1.0  # bias toward remembering
    gate = F.silu((sharding.model_copy(x) @ params["w_gate"]).float())
    return q, k, v, i_logit, f_logit, gate


def _mlstm_chunk(q, k, v, i_log, f_log, carry):
    """One chunk of the stabilised chunkwise mLSTM. q, k, v: (B,H,W,dh);
    i_log, f_log: (B,H,W); carry (C (B,H,dh,dh), n (B,H,dh), m (B,H)).
    Returns (h (B,H,W,dh), the carry at the chunk's end)."""
    C, n, m = carry
    logf_cum = torch.cumsum(F.logsigmoid(f_log), dim=-1)  # F_t
    # running max: m_t = F_t + max(m_carry, cummax_j(i_j - F_j))
    s = i_log - logf_cum
    run = torch.maximum(torch.cummax(s, dim=-1).values, m[..., None])
    m_t = logf_cum + run
    # the carry's contribution, decayed by F_t
    w_carry = torch.exp(m[..., None] + logf_cum - m_t)  # (B,H,W)
    num_inter = torch.einsum("bhwk,bhkv->bhwv", q, C) * w_carry[..., None]
    den_inter = torch.einsum("bhwk,bhk->bhw", q, n) * w_carry
    # the intra-chunk quadratic term: D[t,j] = exp(F_t - F_j + i_j - m_t), j <= t
    expo = logf_cum[..., :, None] - logf_cum[..., None, :] + i_log[..., None, :] - m_t[..., :, None]
    W = q.shape[-2]
    mask = torch.tril(torch.ones((W, W), dtype=torch.bool, device=q.device))
    D = torch.where(mask, torch.exp(expo), torch.zeros((), device=q.device))
    scores = torch.einsum("bhtk,bhjk->bhtj", q, k) * D
    num = num_inter + torch.einsum("bhtj,bhjv->bhtv", scores, v)
    den = den_inter + torch.sum(scores, dim=-1)
    h = num / torch.maximum(torch.abs(den), torch.exp(-m_t))[..., None]
    # the carry at the chunk's end
    F_W = logf_cum[..., -1]
    m_new = F_W + run[..., -1]
    decay_old = torch.exp(m + F_W - m_new)
    w_new = torch.exp(F_W[..., None] - logf_cum + i_log - m_new[..., None])  # (B,H,W)
    kw = k * w_new[..., None]  # one product over w: a three-operand einsum may build (B,H,W,dh,dh)
    C_new = C * decay_old[..., None, None] + torch.einsum("bhwk,bhwv->bhkv", kw, v)
    n_new = n * decay_old[..., None] + torch.sum(kw, dim=-2)
    return h, (C_new, n_new, m_new)


def mlstm_check_prefill(cfg: ArchConfig, seq_len: int) -> None:
    """The mLSTM prefill takes whole chunks: a prompt longer than
    ``mlstm_chunk`` must be a multiple of it. JAX's prefill replays the
    carry without padding (``n_chunks = S // W`` and a reshape), so it fails
    on every other prompt; the port refuses the same ones."""
    W = cfg.mlstm_chunk
    if seq_len > W and seq_len % W:
        raise ValueError(f"mLSTM prefill: a prompt longer than mlstm_chunk={W} must be a multiple of it "
                         f"(got {seq_len}); the cell's state is built from whole chunks")


def mlstm_sequence(params: Params, x: torch.Tensor, cfg: ArchConfig):
    """The full-sequence mLSTM block over chunks of min(mlstm_chunk, S):
    (y (B,S,d), the carry after the last chunk as a decode state). A
    sequence that is no multiple of the chunk is end-padded with input
    gates at -1e30 (padding never reaches a real position); the carry then
    includes the padded steps, so the prefill refuses such prompts
    (``mlstm_check_prefill``)."""
    B, S0, _ = x.shape
    q, k, v, i_log, f_log, gate = _mlstm_qkv_gates(params, x, cfg)
    H, dh = q.shape[-2], q.shape[-1]
    W = min(cfg.mlstm_chunk, S0)
    pad = (-S0) % W
    if pad:
        q, k, v = (F.pad(t, (0, 0, 0, 0, 0, pad)) for t in (q, k, v))
        i_log = F.pad(i_log, (0, 0, 0, pad), value=_M0)
        f_log = F.pad(f_log, (0, 0, 0, pad))
    n_chunks = (S0 + pad) // W

    def to_chunks(t):
        # (B,S,H,*) -> (n_chunks, B, H, W, *)
        if t.dim() == 4:
            return t.reshape(B, n_chunks, W, H, -1).permute(1, 0, 3, 2, 4)
        return t.reshape(B, n_chunks, W, H).permute(1, 0, 3, 2)

    qc, kc, vc = (to_chunks(t.float()) for t in (q, k, v))
    ic, fc = to_chunks(i_log), to_chunks(f_log)
    carry = (torch.zeros((B, H, dh, dh), dtype=torch.float32, device=x.device),
             torch.zeros((B, H, dh), dtype=torch.float32, device=x.device),
             torch.full((B, H), _M0, dtype=torch.float32, device=x.device))
    hs = []
    for c in range(n_chunks):
        h, carry = _mlstm_chunk(qc[c], kc[c], vc[c], ic[c], fc[c], carry)
        hs.append(h)
    # (n_chunks, B, H, W, dh) -> (B, S, up)
    h = torch.stack(hs).permute(1, 0, 3, 2, 4).reshape(B, S0 + pad, H * dh)[:, :S0]
    y = row_parallel((h * gate).to(x.dtype), params["w_down"])
    return y, {"C": carry[0], "n": carry[1], "m": carry[2]}


def mlstm_init_state(cfg: ArchConfig, batch: int, dtype, device=None, stack: Sequence[int] = (),
                     params: Params = None) -> Params:
    """The zero carry; its heads ``params``' (a model rank's) where given."""
    dh = _mlstm_dh(cfg)
    H = max(cfg.num_heads, 1) if params is None else params["wq"].shape[-1] // dh
    return {
        "C": torch.zeros((*stack, batch, H, dh, dh), dtype=torch.float32, device=device),
        "n": torch.zeros((*stack, batch, H, dh), dtype=torch.float32, device=device),
        "m": torch.full((*stack, batch, H), _M0, dtype=torch.float32, device=device),
    }


def mlstm_step(params: Params, x_t: torch.Tensor, state: Params, cfg: ArchConfig):
    """The recurrent single-token step. x_t: (B,1,d) -> (y_t, state)."""
    q, k, v, i_log, f_log, gate = _mlstm_qkv_gates(params, x_t, cfg)
    q, k, v = (t[:, 0].float() for t in (q, k, v))  # (B,H,dh)
    i_log, f_log, gate = i_log[:, 0], f_log[:, 0], gate[:, 0]
    logf = F.logsigmoid(f_log)
    m_new = torch.maximum(logf + state["m"], i_log)
    f_p = torch.exp(logf + state["m"] - m_new)
    i_p = torch.exp(i_log - m_new)
    C = state["C"] * f_p[..., None, None] + i_p[..., None, None] * k[..., :, None] * v[..., None, :]
    n = state["n"] * f_p[..., None] + i_p[..., None] * k
    num = torch.einsum("bhk,bhkv->bhv", q, C)
    den = torch.einsum("bhk,bhk->bh", q, n)
    h = num / torch.maximum(torch.abs(den), torch.exp(-m_new))[..., None]
    B = x_t.shape[0]
    y = row_parallel((h.reshape(B, -1) * gate).to(x_t.dtype), params["w_down"])[:, None]
    return y, {"C": C, "n": n, "m": m_new}


# ---------------------------------------------------------------------------
# sLSTM (xLSTM scalar-memory cell with hidden-dependent gates)
# ---------------------------------------------------------------------------

def init_slstm(gen: torch.Generator, cfg: ArchConfig, stack: Sequence[int] = ()) -> Params:
    d = cfg.d_model
    H = max(cfg.num_heads, 1)
    dh = d // H
    dt = cfg.dtype()
    bias = torch.cat([torch.zeros(d), torch.ones(d), torch.zeros(2 * d)])  # i, f (+1), z, o
    return {
        "w_i": _init_dense(gen, (d, d), dt, stack=stack),
        "w_f": _init_dense(gen, (d, d), dt, stack=stack),
        "w_z": _init_dense(gen, (d, d), dt, stack=stack),
        "w_o": _init_dense(gen, (d, d), dt, stack=stack),
        "r_i": _init_dense(gen, (H, dh, dh), torch.float32, stack=stack),
        "r_f": _init_dense(gen, (H, dh, dh), torch.float32, stack=stack),
        "r_z": _init_dense(gen, (H, dh, dh), torch.float32, stack=stack),
        "r_o": _init_dense(gen, (H, dh, dh), torch.float32, stack=stack),
        "b": bias.to(gen.device).expand(*stack, 4 * d).clone(),
        "w_out": _init_dense(gen, (d, d), dt, stack=stack),
    }


def slstm_init_state(cfg: ArchConfig, batch: int, dtype, device=None, stack: Sequence[int] = (),
                     params: Params = None) -> Params:
    """The zero state; its heads ``params``' (a model rank's) where given."""
    H0 = max(cfg.num_heads, 1)
    dh = cfg.d_model // H0
    H = H0 if params is None else params["r_i"].shape[-3]
    z = lambda: torch.zeros((*stack, batch, H, dh), dtype=torch.float32, device=device)
    return {"h": z(), "c": z(), "n": z() + 1e-6, "m": z()}


def _slstm_cell(params: Params, pre: torch.Tensor, state: Params, H: int, dh: int):
    """pre: (B, 4d) input projections [i, f, z, o]; state: dict of (B,H,dh)."""
    B = pre.shape[0]
    h_prev = state["h"]
    rec = lambda r: torch.einsum("bhk,hkj->bhj", h_prev, r)
    pre = pre.reshape(B, 4, H, dh)
    i_t = pre[:, 0] + rec(params["r_i"])
    f_t = pre[:, 1] + rec(params["r_f"])
    z_t = torch.tanh(pre[:, 2] + rec(params["r_z"]))
    o_t = torch.sigmoid(pre[:, 3] + rec(params["r_o"]))
    m_new = torch.maximum(f_t + state["m"], i_t)
    i_p = torch.exp(i_t - m_new)
    f_p = torch.exp(f_t + state["m"] - m_new)
    c = f_p * state["c"] + i_p * z_t
    n = f_p * state["n"] + i_p
    h = o_t * c / torch.clamp_min(n, 1e-6)
    return h, {"h": h, "c": c, "n": n, "m": m_new}


def _slstm_pre(params: Params, x: torch.Tensor) -> torch.Tensor:
    """The [i, f, z, o] input projections (..., 4 H dh) f32; on a model rank
    its heads' columns of each."""
    w = torch.cat([params["w_i"], params["w_f"], params["w_z"], params["w_o"]], dim=1)
    return (sharding.model_copy(x) @ w).float() + params["b"]


def slstm_sequence(params: Params, x: torch.Tensor, cfg: ArchConfig):
    """The full-sequence sLSTM block, one step at a time: (y (B,S,d), the
    state after the last position). On a model rank the loop runs its
    heads."""
    B, S, _ = x.shape
    H, dh = params["r_i"].shape[-3], params["r_i"].shape[-1]
    pre_all = _slstm_pre(params, x)  # (B,S,4 H dh)
    state = slstm_init_state(cfg, B, x.dtype, x.device, params=params)
    hs = []
    for t in range(S):
        h, state = _slstm_cell(params, pre_all[:, t], state, H, dh)
        hs.append(h)
    h = torch.stack(hs, dim=1).reshape(B, S, H * dh)
    return row_parallel(h.to(x.dtype), params["w_out"]), state


def slstm_step(params: Params, x_t: torch.Tensor, state: Params, cfg: ArchConfig):
    """x_t: (B,1,d) -> (y_t, state)."""
    B = x_t.shape[0]
    H, dh = params["r_i"].shape[-3], params["r_i"].shape[-1]
    h, state = _slstm_cell(params, _slstm_pre(params, x_t[:, 0]), state, H, dh)
    return row_parallel(h.reshape(B, H * dh).to(x_t.dtype), params["w_out"])[:, None], state
