"""Decoder stack: pattern-cycled blocks in stacked superblocks, the full
forward, the LM loss, and serving (prefill + single-token decode with
caches); the counterpart of ``repro.models.transformer`` for every block
kind: ``attn`` and ``local_attn`` (GQA, or MLA when ``cfg.mla`` is set;
followed by the MoE when ``cfg.moe`` is set, else the MLP), ``rglru``,
``mlstm`` and ``slstm``.

The stack is ``num_superblocks`` repetitions of ``cfg.block_pattern`` plus
an unscanned tail (recurrentgemma's 38 = 12 x (rglru, rglru, local_attn) + 2).
The JAX layout is kept: the ``"blocks"`` leaves carry a leading superblock
axis (JAX builds it with ``jax.vmap``), ``tail{t}`` hold the tail, and
``blocks_unrolled`` is a list when ``cfg.scan_layers`` is off. A Python loop
over the superblock index replaces ``lax.scan``; ``cfg.remat`` has no
effect here (the engine's ``precision.remat`` recomputes a client's whole
loss). JAX's ``forward`` returns (logits, MoE aux loss): the port's
``forward_with_aux`` does, and ``forward`` returns the logits alone; the
LM loss is cross-entropy plus the aux, as JAX's.

``forward`` (without explicit ``positions``) and ``prefill`` build the
positions ``arange(S)`` themselves and say so to the layers
(``default_positions``), so on the card, where autograd records nothing,
every attention layer runs K7 (MLA with v zero-padded to the q/k head dim)
and every RG-LRU layer K8. The prefill takes each block's decode state
from the block's own full-sequence pass: the RG-LRU's scan, MLA's latent,
the mLSTM's last chunk carry and the sLSTM's last state (JAX replays the
recurrent cells a second time; the values are the same function), so a
prefill launches K7 once per attention layer and K8 once per RG-LRU layer.
The mLSTM prefill takes whole chunks only, as JAX's replay does
(``recurrent.mlstm_check_prefill``).

Under a hint mesh whose "model" axis is larger than 1 (tensor parallelism;
``dist.sharding.refuse_model_axis`` names the counts that do not split)
a rank holds ``embed``'s d / M columns and gathers the embedded tokens
(JAX's spec for the leaf; the gather's backward needs no collective),
``lm_head``'s V / M columns, and the layers' slices (its decode caches
its KV heads, its RG-LRU channels and its xLSTM heads; MLA's latent cache
whole). ``forward_with_aux``
then returns the rank's (B, S, V / M) logits, the loss is vocab-parallel
(``cross_entropy``: no rank holds (B, S, V)), and ``prefill`` /
``decode_step`` gather the (B, V) logits, so greedy tokens are one
device's. A vocabulary (or model width) that does not split keeps its
leaf whole on every rank, as JAX's rule does (granite-3-2b's 49,155): the
rank then computes the whole logits (or embedding) and the loss as off
the mesh.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.dist import sharding
from repro_torch.models import layers, recurrent
from repro_torch.tree import tree_map

PyTree = Any
ATTN_KINDS = ("attn", "local_attn")
BLOCK_KINDS = ATTN_KINDS + ("rglru", "mlstm", "slstm")


def _check_kind(kind: str) -> None:
    if kind not in BLOCK_KINDS:
        raise ValueError(kind)


# ---------------------------------------------------------------------------
# Single block
# ---------------------------------------------------------------------------

def init_block(gen: torch.Generator, cfg: ArchConfig, kind: str, stack=()) -> Dict[str, PyTree]:
    _check_kind(kind)
    d, dt = cfg.d_model, cfg.dtype()
    p: Dict[str, PyTree] = {"norm1": layers.init_rmsnorm(d, dt, gen.device, stack)}
    if kind in ATTN_KINDS:
        p["attn"] = layers.init_mla(gen, cfg, stack) if cfg.mla else layers.init_attention(gen, cfg, stack)
        if cfg.moe is not None:
            p["norm2"] = layers.init_rmsnorm(d, dt, gen.device, stack)
            p["moe"] = layers.init_moe(gen, cfg, stack)
            return p
    elif kind == "rglru":
        p["rnn"] = recurrent.init_rglru(gen, cfg, stack)
    else:  # the xLSTM cells carry their own up / down projections: no MLP
        p["cell"] = (recurrent.init_mlstm if kind == "mlstm" else recurrent.init_slstm)(gen, cfg, stack)
        return p
    if cfg.d_ff > 0:
        p["norm2"] = layers.init_rmsnorm(d, dt, gen.device, stack)
        p["mlp"] = layers.init_mlp(gen, d, cfg.d_ff, dt, stack)
    return p


def _ffn_residual(params, x, cfg: ArchConfig):
    """x + MoE or MLP of rmsnorm(x) where the block has one; returns (x,
    the MoE aux loss or None)."""
    if "moe" in params:
        h = layers.rmsnorm(x, params["norm2"], cfg.norm_eps)
        B, S, d = h.shape
        y, aux = layers.moe_apply(params["moe"], h.reshape(B * S, d), cfg)
        return x + y.reshape(B, S, d), aux
    if "mlp" in params:
        x = x + layers.mlp_apply(params["mlp"], layers.rmsnorm(x, params["norm2"], cfg.norm_eps))
    return x, None


def _block_run(params, x, cfg: ArchConfig, kind: str, positions, default_positions: bool):
    """The full-sequence block; returns (x, MoE aux loss or None, what the
    block's decode cache is built from: (k, v) for attention, (c_kv,
    k_rope) for MLA, (h_S, u) for RG-LRU, the state for mLSTM / sLSTM)."""
    _check_kind(kind)
    h = layers.rmsnorm(x, params["norm1"], cfg.norm_eps)
    if kind in ATTN_KINDS:
        if cfg.mla:
            y, c_kv, k_rope = layers.mla_with_latent(params["attn"], h, cfg, positions,
                                                     default_positions=default_positions)
            state = (c_kv, k_rope)
        else:
            window = cfg.window if kind == "local_attn" else 0
            y, k, v = layers.attention_with_kv(params["attn"], h, cfg, positions, window=window,
                                               default_positions=default_positions)
            state = (k, v)
    elif kind == "rglru":
        y, h_last, u = recurrent.rglru_sequence(params["rnn"], h, cfg, default_positions=default_positions)
        state = (h_last, u)
    elif kind == "mlstm":
        y, state = recurrent.mlstm_sequence(params["cell"], h, cfg)
    else:
        y, state = recurrent.slstm_sequence(params["cell"], h, cfg)
    x, aux = _ffn_residual(params, x + y, cfg)
    return x, aux, state


def block_apply(params, x, cfg: ArchConfig, kind: str, positions, *,
                default_positions: bool = False) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Full-sequence block: (B,S,d) -> ((B,S,d), MoE aux loss or None)."""
    return _block_run(params, x, cfg, kind, positions, default_positions)[:2]


def block_init_cache(cfg: ArchConfig, kind: str, batch: int, max_len: int, dtype, device=None, stack=(), *,
                     params) -> PyTree:
    """A block's empty decode cache; a recurrent block's state sized from
    its ``params`` (a model rank's channels or heads)."""
    _check_kind(kind)
    if kind in ATTN_KINDS:
        if cfg.mla:
            return layers.init_mla_cache(cfg, batch, max_len, dtype, device, stack)
        window = cfg.window if kind == "local_attn" else 0
        eff = min(max_len, window) if window else max_len
        return layers.init_kv_cache(cfg, batch, eff if window else max_len, dtype, device, stack)
    init = {"rglru": recurrent.rglru_init_state, "mlstm": recurrent.mlstm_init_state,
            "slstm": recurrent.slstm_init_state}[kind]
    return init(cfg, batch, dtype, device, stack, params=params["rnn" if kind == "rglru" else "cell"])


def block_decode(params, x, cache, cfg: ArchConfig, kind: str, position) -> Tuple[torch.Tensor, PyTree]:
    _check_kind(kind)
    h = layers.rmsnorm(x, params["norm1"], cfg.norm_eps)
    if kind in ATTN_KINDS and cfg.mla:
        y, cache = layers.mla_decode(params["attn"], h, cache, cfg, position)
    elif kind in ATTN_KINDS:
        window = cfg.window if kind == "local_attn" else 0
        y, cache = layers.attention_decode(params["attn"], h, cache, cfg, position, window=window)
    elif kind == "rglru":
        y, cache = recurrent.rglru_step(params["rnn"], h, cache, cfg)
    elif kind == "mlstm":
        y, cache = recurrent.mlstm_step(params["cell"], h, cache, cfg)
    else:
        y, cache = recurrent.slstm_step(params["cell"], h, cache, cfg)
    return _ffn_residual(params, x + y, cfg)[0], cache


# ---------------------------------------------------------------------------
# Full model
# ---------------------------------------------------------------------------

def _stacked(cfg: ArchConfig, params=None) -> bool:
    return cfg.scan_layers and cfg.num_superblocks > 0 and (params is None or "blocks" in params)


def init_params(gen: torch.Generator, cfg: ArchConfig, *, mesh=None) -> Dict[str, PyTree]:
    """Random parameters on ``gen``'s device with JAX's tree, names, shapes,
    dtypes and scales (other numbers than JAX's init draws). With ``mesh``
    (a rank's ``dist.sharding.RankMesh``) each leaf or block is cut to the
    rank's part (``sharding.rank_params``) as soon as it is drawn, so a
    rank never holds the whole model; the numbers are the whole init's."""
    dt = cfg.dtype()

    def cut(path, tree):
        if mesh is None:
            return tree
        nest = tree
        for key in reversed(path):
            nest = {key: nest}
        part = sharding.rank_params(nest, mesh, cfg)
        for key in path:
            part = part[key]
        return tree_map(torch.clone, part)  # copies: a view would keep the whole leaf alive

    params: Dict[str, PyTree] = {}
    if cfg.embed_inputs:
        params["embed"] = cut(("embed",), layers._init_dense(gen, (cfg.vocab_size, cfg.d_model), dt, scale=1.0))
    if _stacked(cfg):
        params["blocks"] = {f"b{i}": cut(("blocks", f"b{i}"), init_block(gen, cfg, kind, (cfg.num_superblocks,)))
                            for i, kind in enumerate(cfg.block_pattern)}
    else:
        params["blocks_unrolled"] = [
            cut(("blocks_unrolled", i), init_block(gen, cfg, cfg.block_pattern[i % cfg.pattern_period]))
            for i in range(cfg.num_layers - cfg.tail_layers)
        ]
    for t in range(cfg.tail_layers):
        params[f"tail{t}"] = cut((f"tail{t}",), init_block(gen, cfg, cfg.block_pattern[t]))
    params["final_norm"] = layers.init_rmsnorm(cfg.d_model, dt, gen.device)
    params["lm_head"] = cut(("lm_head",), layers._init_dense(gen, (cfg.d_model, cfg.vocab_size), dt))
    return params



def _index(tree, i: int):
    """Superblock ``i`` of a stacked tree (views, no copies)."""
    return {k: _index(v, i) for k, v in tree.items()} if isinstance(tree, dict) else tree[i]


def _stack(trees):
    first = trees[0]
    if isinstance(first, dict):
        return {k: _stack([t[k] for t in trees]) for k in first}
    return torch.stack(trees)


def _layers(params, cfg: ArchConfig):
    """(where, kind, block params) in execution order; ``where`` is
    ("blocks", superblock, "b{i}"), ("blocks_unrolled", i) or ("tail{t}",)."""
    if _stacked(cfg, params):
        for s in range(cfg.num_superblocks):
            sb = _index(params["blocks"], s)
            for i, kind in enumerate(cfg.block_pattern):
                yield ("blocks", s, f"b{i}"), kind, sb[f"b{i}"]
    elif "blocks_unrolled" in params:
        for i, bp in enumerate(params["blocks_unrolled"]):
            yield ("blocks_unrolled", i), cfg.block_pattern[i % cfg.pattern_period], bp
    for t in range(cfg.tail_layers):
        yield (f"tail{t}",), cfg.block_pattern[t], params[f"tail{t}"]


def backbone(params, cfg: ArchConfig, x: torch.Tensor, positions: torch.Tensor, *,
             default_positions: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """(B,S,d) -> ((B,S,d) hidden states, the MoE aux losses summed over
    the layers, f32; 0 without MoE)."""
    total_aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for _, kind, bp in _layers(params, cfg):
        x, aux = block_apply(bp, x, cfg, kind, positions, default_positions=default_positions)
        if aux is not None:
            total_aux = total_aux + aux
    return x, total_aux


def _embed(params, cfg: ArchConfig, inputs: torch.Tensor) -> torch.Tensor:
    if cfg.embed_inputs:
        # not ``params["embed"][inputs]``: its gradient is an accumulating
        # ``index_put_``, whose adds of a repeated token's rows follow the
        # threads' timing on the CPU and atomics on the card. The
        # embedding's own backward adds them in token order. A model rank
        # looks up its d / M columns and gathers the rest.
        x = torch.nn.functional.embedding(inputs, params["embed"])
        return sharding.model_gather(x) if params["embed"].shape[-1] != cfg.d_model else x
    return inputs.to(cfg.dtype())


def _vocab_split(params, cfg: ArchConfig) -> bool:
    """Whether this rank holds a slice of the LM head's vocabulary."""
    return params["lm_head"].shape[-1] != cfg.vocab_size


def _logits(params, cfg: ArchConfig, x: torch.Tensor) -> torch.Tensor:
    """The LM head: this rank's vocabulary columns on a model rank."""
    return (sharding.model_copy(x) if _vocab_split(params, cfg) else x) @ params["lm_head"]


def _whole_logits(params, cfg: ArchConfig, x: torch.Tensor) -> torch.Tensor:
    """(B, V) logits of (B, d) states, gathered from the model ranks."""
    logits = _logits(params, cfg, x)
    return sharding.model_gather(logits) if _vocab_split(params, cfg) else logits


def _default_positions(x: torch.Tensor) -> torch.Tensor:
    B, S = x.shape[0], x.shape[1]
    return torch.arange(S, dtype=torch.int32, device=x.device).expand(B, S)


def forward_with_aux(params, cfg: ArchConfig, inputs: torch.Tensor, positions: Optional[torch.Tensor] = None):
    """inputs: int tokens (B,S) if cfg.embed_inputs else embeddings (B,S,d).
    Returns (logits (B,S,V), MoE aux loss), as JAX's ``forward``; on a
    model rank its (B,S,V/M) logits."""
    sharding.refuse_model_axis(sharding.hint_mesh(), cfg)
    x = _embed(params, cfg, inputs)
    default = positions is None
    if default:
        positions = _default_positions(x)
    x, aux = backbone(params, cfg, x, positions, default_positions=default)
    x = layers.rmsnorm(x, params["final_norm"], cfg.norm_eps)
    return _logits(params, cfg, x), aux


def forward(params, cfg: ArchConfig, inputs: torch.Tensor, positions: Optional[torch.Tensor] = None):
    """The logits (B,S,V) of ``forward_with_aux``."""
    return forward_with_aux(params, cfg, inputs, positions)[0]


def cross_entropy(logits: torch.Tensor, targets: torch.Tensor, mask: Optional[torch.Tensor] = None, *,
                  vocab: Optional[int] = None):
    """logsumexp - target logit, in f32. targets: (B,S) int. On a model
    rank ``logits`` are its vocabulary columns (``forward_with_aux``;
    ``vocab``, the whole vocabulary where known, says whether they are)
    and the loss is vocab-parallel: the global max, then the sums of exp
    and of the target logit (each rank adds the targets it holds) from one
    all-reduce."""
    lf = logits.float()
    if sharding.hint_model_mesh() is not None and lf.shape[-1] != vocab:
        nll = _vocab_parallel_nll(lf, targets)
    else:
        lse = torch.logsumexp(lf, dim=-1)
        tgt = torch.gather(lf, -1, targets[..., None].long())[..., 0]
        nll = lse - tgt
    if mask is not None:
        return torch.sum(nll * mask) / torch.clamp_min(torch.sum(mask), 1.0)
    return torch.mean(nll)


def _vocab_parallel_nll(lf: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """-log softmax at the targets from this rank's f32 logit columns."""
    v = lf.shape[-1]
    shift = sharding.model_max(torch.amax(lf, dim=-1))
    local = targets.long() - sharding.model_offset(v)
    held = (local >= 0) & (local < v)
    tgt = torch.gather(lf, -1, torch.clamp(local, 0, v - 1)[..., None])[..., 0]
    sums = sharding.model_reduce(torch.stack([torch.sum(torch.exp(lf - shift[..., None]), dim=-1),
                                              torch.where(held, tgt, torch.zeros_like(tgt))]))
    return shift + torch.log(sums[0]) - sums[1]


def make_loss_fn(cfg: ArchConfig):
    """Per-client loss: cross-entropy + the MoE aux loss, as JAX's;
    loss_fn(params, batch, rng) -> scalar. batch: {"inputs": tokens (b,S)
    or embeds (b,S,d), "targets": (b,S) int}."""

    def loss_fn(params, batch, rng):
        logits, aux = forward_with_aux(params, cfg, batch["inputs"])
        return cross_entropy(logits, batch["targets"], batch.get("mask"), vocab=cfg.vocab_size) + aux

    return loss_fn


# ---------------------------------------------------------------------------
# Serving: prefill + single-token decode with stacked caches
# ---------------------------------------------------------------------------

def _block_prefill(params, x, cfg: ArchConfig, kind: str, positions, max_len: int, *, default_positions: bool):
    """Run the block over the prompt AND build its decode cache."""
    y, _, state = _block_run(params, x, cfg, kind, positions, default_positions)
    if kind in ("mlstm", "slstm"):  # the cell's state after the last position
        return y, state
    B, S, _ = x.shape
    dtype = cfg.dtype()
    cache = block_init_cache(cfg, kind, B, max_len, dtype, x.device, params=params)
    if kind in ATTN_KINDS and cfg.mla:  # the latent, in slots 0..S-1 (no ring)
        c_kv, k_rope = state
        cache["c_kv"][:, :S] = c_kv.to(dtype)
        cache["k_rope"][:, :S] = k_rope.to(dtype)
        cache["pos"][:, :S] = positions.to(torch.int32)
    elif kind in ATTN_KINDS:
        k, v = state
        L = cache["k"].shape[1]
        take = min(S, L)
        slots = torch.remainder(positions[:, -take:], L).long()
        bidx = torch.arange(B, device=x.device)[:, None]
        cache["k"][bidx, slots] = k[:, -take:].to(dtype)
        cache["v"][bidx, slots] = v[:, -take:].to(dtype)
        cache["pos"][bidx, slots] = positions[:, -take:].to(torch.int32)
    else:  # rglru: h_S with h_0 = 0, and the last 3 pre-conv inputs
        h_last, u = state
        cache["h"] = h_last
        cache["conv"] = u[:, -3:].to(dtype)
    return y, cache


def prefill(params, cfg: ArchConfig, inputs: torch.Tensor, max_len: int):
    """Full-prompt forward building every layer's decode cache.
    Returns (last-position logits (B,V), caches). With mLSTM blocks a
    prompt longer than ``cfg.mlstm_chunk`` must be a multiple of it."""
    sharding.refuse_model_axis(sharding.hint_mesh(), cfg)
    x = _embed(params, cfg, inputs)
    if "mlstm" in cfg.block_pattern:
        recurrent.mlstm_check_prefill(cfg, x.shape[1])
    positions = _default_positions(x)
    caches: Dict[str, PyTree] = {}
    stacked = []
    for where, kind, bp in _layers(params, cfg):
        x, c = _block_prefill(bp, x, cfg, kind, positions, max_len, default_positions=True)
        if where[0] == "blocks":
            if where[2] == "b0":
                stacked.append({})
            stacked[-1][where[2]] = c
        elif where[0] == "blocks_unrolled":
            caches.setdefault("blocks_unrolled", []).append(c)
        else:
            caches[where[0]] = c
    if stacked:
        caches["blocks"] = _stack(stacked)
    x = layers.rmsnorm(x, params["final_norm"], cfg.norm_eps)
    return _whole_logits(params, cfg, x[:, -1]), caches


def init_decode_caches(params, cfg: ArchConfig, batch: int, max_len: int, device=None):
    """Fresh (empty) caches matching the model structure: a model rank's KV
    heads under the hint mesh, and its recurrent blocks' channels and heads
    (read from ``params``)."""
    dtype = cfg.dtype()
    caches: Dict[str, PyTree] = {}
    if _stacked(cfg, params):
        caches["blocks"] = {
            f"b{i}": block_init_cache(cfg, kind, batch, max_len, dtype, device, stack=(cfg.num_superblocks,),
                                      params=params["blocks"][f"b{i}"])
            for i, kind in enumerate(cfg.block_pattern)
        }
    elif "blocks_unrolled" in params:
        caches["blocks_unrolled"] = [
            block_init_cache(cfg, cfg.block_pattern[i % cfg.pattern_period], batch, max_len, dtype, device,
                             params=bp)
            for i, bp in enumerate(params["blocks_unrolled"])
        ]
    for t in range(cfg.tail_layers):
        caches[f"tail{t}"] = block_init_cache(cfg, cfg.block_pattern[t], batch, max_len, dtype, device,
                                              params=params[f"tail{t}"])
    return caches


def decode_step(params, cfg: ArchConfig, caches, tokens: torch.Tensor, position: torch.Tensor):
    """One decode step for all requests. tokens: (B,) int (or (B,d)
    embeddings for stub-frontend archs); position: (B,) absolute positions.
    Returns (logits (B,V), caches); the input caches are left as they were."""
    sharding.refuse_model_axis(sharding.hint_mesh(), cfg)
    x = _embed(params, cfg, tokens)[:, None]
    new: Dict[str, PyTree] = {}
    stacked = []
    for where, kind, bp in _layers(params, cfg):
        if where[0] == "blocks":
            cache = _index(caches["blocks"][where[2]], where[1])
        elif where[0] == "blocks_unrolled":
            cache = caches["blocks_unrolled"][where[1]]
        else:
            cache = caches[where[0]]
        x, c = block_decode(bp, x, cache, cfg, kind, position)
        if where[0] == "blocks":
            if where[2] == "b0":
                stacked.append({})
            stacked[-1][where[2]] = c
        elif where[0] == "blocks_unrolled":
            new.setdefault("blocks_unrolled", []).append(c)
        else:
            new[where[0]] = c
    if stacked:
        new["blocks"] = _stack(stacked)
    x = layers.rmsnorm(x, params["final_norm"], cfg.norm_eps)
    return _whole_logits(params, cfg, x[:, 0]), new
