"""The port's MoE and MLA (DeepSeek-V3 multi-head latent attention) against
the JAX package, on the CPU: the MoE layer (routing, the sort-based
fixed-capacity dispatch with its drops, the expert SwiGLU, the shared and
dense branches, the Switch aux loss), the full-sequence MLA, its latent
prefill cache and its absorbed-matrix decode, the K7 route with v
zero-padded to the q/k head dim, the forward with CE + aux, and the
engine's ``grad(vmap(loss))`` over two clients.

The JAX init is carried across with ``models.params_from_numpy`` and the
same numpy inputs go to both. Tolerances: f32 layer outputs ``rtol=1e-5``
and ``atol`` 1e-6 of the output's largest |value| (at least 1e-6: the
smoke MoE's outputs reach |y| ~ 100, its experts' init scale being
num_experts^-0.5, and a near-zero element that cancels terms of that size
sits up to 2.3e-5 apart, measured); logits and losses ``rtol=atol=1e-5``
(|logits| <= 4, as ``test_torch_lm.py``); gradients within 1e-5 of each
leaf's largest.
Router inputs are random f32 numbers, so no two router probabilities of a
token tie and ``torch.topk`` picks the experts ``lax.top_k`` picks (on a
tie the two may order the experts otherwise).
"""
import dataclasses
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._pytree import tree_flatten, tree_flatten_with_path, tree_unflatten

from repro.configs import registry as jreg
from repro.models import layers as jlayers
from repro.models import transformer as jt
from repro_torch import models as tmodels
from repro_torch.configs import registry as treg
from repro_torch.core import hierfavg
from repro_torch.kernels import flash_attention as tfa
from repro_torch.models import layers as tlayers
from repro_torch.models import transformer as tt

LAYER = dict(rtol=1e-5, atol=1e-6)
F32 = dict(rtol=1e-5, atol=1e-5)


def _layer_close(got, want, err_msg=""):
    """The layer tolerance: rtol 1e-5, atol 1e-6 of max(1, max |want|)."""
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(np.asarray(got, np.float32), want, rtol=1e-5,
                               atol=1e-6 * max(1.0, float(np.abs(want).max())), err_msg=err_msg)
MOE_ARCHS = ["arctic-480b", "deepseek-v3-671b"]


def _configs(arch, **changes):
    j, t = jreg.get_smoke(arch), treg.get_smoke(arch)
    if changes:
        j, t = dataclasses.replace(j, **changes), dataclasses.replace(t, **changes)
    return j, t


def _moe_configs(arch, capacity_factor):
    j, t = _configs(arch)
    return (dataclasses.replace(j, moe=dataclasses.replace(j.moe, capacity_factor=capacity_factor)),
            dataclasses.replace(t, moe=dataclasses.replace(t.moe, capacity_factor=capacity_factor)))


def _carry(jcfg, tcfg, seed=0):
    jp = jt.init_params(jax.random.PRNGKey(seed), jcfg)
    like = tt.init_params(torch.Generator().manual_seed(seed), tcfg)
    return jp, tmodels.params_from_numpy(jax.device_get(jp), "cpu", like=like)


def _assert_trees_close(jtree, ttree, path="", **tol):
    if isinstance(jtree, dict):
        assert set(jtree) == set(ttree), (path, sorted(jtree), sorted(ttree))
        for k in jtree:
            _assert_trees_close(jtree[k], ttree[k], f"{path}/{k}", **tol)
        return
    j = np.asarray(jax.device_get(jtree))
    t = ttree.detach().cpu()
    assert tuple(j.shape) == tuple(t.shape), (path, j.shape, tuple(t.shape))
    assert str(j.dtype) == str(t.dtype).replace("torch.", ""), (path, j.dtype, t.dtype)
    if j.dtype.kind in "iu":
        np.testing.assert_array_equal(t.numpy(), j, err_msg=path)
    else:
        np.testing.assert_allclose(t.float().numpy(), j.astype(np.float32), err_msg=path, **tol)


# -- MoE ------------------------------------------------------------------------------


@pytest.mark.parametrize("arch", MOE_ARCHS)
@pytest.mark.parametrize("capacity_factor", [1.25, 0.25])
def test_moe_apply_tracks_jax(arch, capacity_factor, rng):
    """y and the aux loss at 64 tokens; a capacity factor of 0.25 gives 16
    slots an expert against 32 assignments on average, so assignments are
    dropped (counted here), and dropped ones add nothing to y."""
    jcfg, tcfg = _moe_configs(arch, capacity_factor)
    jp = jlayers.init_moe(jax.random.PRNGKey(3), jcfg)
    tp = tmodels.params_from_numpy(jax.device_get(jp))
    like = tlayers.init_moe(torch.Generator().manual_seed(0), tcfg)
    tmodels.params_from_numpy(jax.device_get(jp), like=like)  # names, shapes and dtypes
    x = rng.normal(size=(64, jcfg.d_model)).astype(np.float32)
    jy, jaux = jlayers.moe_apply(jp, jnp.asarray(x), jcfg)
    ty, taux = tlayers.moe_apply(tp, torch.from_numpy(x), tcfg)
    assert ty.shape == (64, jcfg.d_model) and ty.dtype == torch.float32 and taux.dtype == torch.float32
    _layer_close(ty.numpy(), jy)
    _layer_close(float(taux), float(jaux))
    _, _, ids = tlayers.moe_route(tp["router"], torch.from_numpy(x), tcfg.moe.top_k)
    _, _, ranks, _ = tlayers.moe_ranks(ids.reshape(-1), tcfg.moe.num_experts)
    dropped = int((ranks >= tlayers.moe_capacity(64, tcfg)).sum())
    assert (dropped > 0) == (capacity_factor < 1), dropped


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_bf16_moe_apply_is_within_one_ulp_of_jax(arch, rng):
    """In bf16 on the CPU the expert products upcast a block of experts at a
    time (``layers._matmul_f32``: h and g in f32, as JAX's
    ``preferred_element_type``). Each expert's down product rounds to bf16
    after an f32 sum in another order than XLA's, so an expert output can
    sit one bf16 ulp apart, and y, their gated sum, by up to one bf16 ulp of
    the largest |y| (measured: half of one, on 3-4 % of the elements)."""
    jcfg, tcfg = _configs(arch, param_dtype="bfloat16", compute_dtype="bfloat16")
    jp = jlayers.init_moe(jax.random.PRNGKey(3), jcfg)
    tp = tmodels.params_from_numpy(jax.device_get(jp))
    x = rng.normal(size=(64, jcfg.d_model)).astype(np.float32)
    jy, jaux = jlayers.moe_apply(jp, jnp.asarray(x, jnp.bfloat16), jcfg)
    ty, taux = tlayers.moe_apply(tp, torch.from_numpy(x).to(torch.bfloat16), tcfg)
    assert ty.dtype == torch.bfloat16
    want = np.asarray(jy.astype(jnp.float32))
    ulp = 2.0 ** (np.floor(np.log2(np.abs(want).max())) - 7)
    np.testing.assert_allclose(ty.float().numpy(), want, rtol=0, atol=ulp)
    _layer_close(float(taux), float(jaux))


def test_moe_ranks_follow_token_order_within_each_expert():
    """Each assignment's rank counts the earlier assignments (in token-major
    order) to the same expert, as JAX's stable argsort gives."""
    flat_e = torch.tensor([2, 0, 2, 1, 0, 2, 2, 1])
    counts, starts, ranks, order = tlayers.moe_ranks(flat_e, 4)
    assert counts.tolist() == [2, 2, 4, 0] and starts.tolist() == [0, 2, 4, 8]
    assert ranks.tolist() == [0, 0, 1, 0, 1, 2, 3, 1]
    assert order.tolist() == [1, 4, 3, 7, 0, 2, 5, 6]
    assert [tlayers.moe_capacity(n, treg.get_config("deepseek-v3-671b")) for n in (1, 4096)] == [8, 168]


# -- MLA ------------------------------------------------------------------------------


def test_mla_apply_and_decode_track_jax(rng):
    """The full-sequence MLA at 12 positions, then 5 absorbed decode steps
    from an empty latent cache: y and every cache leaf."""
    jcfg, tcfg = _configs("deepseek-v3-671b")
    jp = jlayers.init_mla(jax.random.PRNGKey(5), jcfg)
    tp = tmodels.params_from_numpy(jax.device_get(jp), like=tlayers.init_mla(torch.Generator(), tcfg))
    x = rng.normal(size=(2, 12, jcfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(12, dtype=np.int32), (2, 12)).copy()
    want = jlayers.mla_apply(jp, jnp.asarray(x), jcfg, jnp.asarray(pos))
    got, c_kv, k_rope = tlayers.mla_with_latent(tp, torch.from_numpy(x), tcfg, torch.from_numpy(pos))
    _layer_close(got.numpy(), want)
    assert c_kv.shape == (2, 12, tcfg.mla.kv_lora_rank) and k_rope.shape == (2, 12, tcfg.mla.qk_rope_head_dim)

    jc = jlayers.init_mla_cache(jcfg, 2, 8, jnp.float32)
    tc = tlayers.init_mla_cache(tcfg, 2, 8, torch.float32)
    _assert_trees_close(jc, tc, **LAYER)
    for t in range(5):
        position = np.array([t, t + 2], np.int32)  # the two rows at other positions
        jy, jc = jlayers.mla_decode(jp, jnp.asarray(x[:, t:t + 1]), jc, jcfg, jnp.asarray(position))
        ty, tc = tlayers.mla_decode(tp, torch.from_numpy(x[:, t:t + 1]), tc, tcfg, torch.from_numpy(position))
        _layer_close(ty.numpy(), jy)
        _assert_trees_close(jc, tc, **LAYER)


@pytest.mark.parametrize("chunk", [0, 4])
def test_mla_padded_v_route_is_the_layer_code(chunk, monkeypatch, rng):
    """With the card test forced true, the default positions send MLA's
    attention to K7's wrapper once, with v zero-padded to the q/k head dim
    (on the CPU the wrapper runs ``attention_plain``); the sliced output
    equals the layer code's (naive, or chunked at ``attn_chunk`` 4) and
    JAX's ``mla_apply``."""
    jcfg, tcfg = _configs("deepseek-v3-671b", attn_chunk=chunk)
    jp = jlayers.init_mla(jax.random.PRNGKey(6), jcfg)
    tp = tmodels.params_from_numpy(jax.device_get(jp))
    seen = []

    def spy(q, k, v, **kw):
        seen.append((tuple(q.shape), tuple(k.shape), tuple(v.shape), v))
        return tfa.attention_plain(q, k, v, **kw)

    monkeypatch.setattr(tlayers, "_on_card", lambda t: True)
    monkeypatch.setattr(tfa, "attention", spy)
    x = rng.normal(size=(2, 16, jcfg.d_model)).astype(np.float32)
    pos = torch.arange(16, dtype=torch.int32).expand(2, 16)
    with torch.no_grad():
        kern = tlayers.mla_with_latent(tp, torch.from_numpy(x), tcfg, pos, default_positions=True)[0]
        assert len(seen) == 1
        plain = tlayers.mla_with_latent(tp, torch.from_numpy(x), tcfg, pos)[0]
    assert len(seen) == 1
    m = tcfg.mla
    qk, dv = m.qk_nope_head_dim + m.qk_rope_head_dim, m.v_head_dim
    assert seen[0][:3] == ((2, 16, tcfg.num_heads, qk),) * 3
    assert not seen[0][3][..., dv:].any()
    _layer_close(kern.numpy(), plain.numpy())
    _layer_close(kern.numpy(), jlayers.mla_apply(jp, jnp.asarray(x), jcfg, jnp.asarray(pos.numpy())))


# -- the decoder stack ----------------------------------------------------------------


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_forward_aux_and_loss_track_jax(arch, rng):
    jcfg, tcfg = _configs(arch)
    jp, tp = _carry(jcfg, tcfg)
    x = rng.integers(0, jcfg.vocab_size, size=(2, 16)).astype(np.int32)
    y = rng.integers(0, jcfg.vocab_size, size=(2, 16)).astype(np.int32)
    jl, jaux = jt.forward(jp, jcfg, jnp.asarray(x))
    tl, taux = tt.forward_with_aux(tp, tcfg, torch.from_numpy(x))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **F32)
    assert float(jaux) > 0
    _layer_close(float(taux), float(jaux))
    np.testing.assert_array_equal(tt.forward(tp, tcfg, torch.from_numpy(x)).numpy(), tl.numpy())
    jloss = jt.make_loss_fn(jcfg)(jp, {"inputs": jnp.asarray(x), "targets": jnp.asarray(y)}, None)
    tloss = tt.make_loss_fn(tcfg)(tp, {"inputs": torch.from_numpy(x), "targets": torch.from_numpy(y)}, None)
    np.testing.assert_allclose(float(tloss), float(jloss), **F32)
    ce = tt.cross_entropy(tl, torch.from_numpy(y))
    np.testing.assert_allclose(float(tloss - ce), float(taux), rtol=1e-4)  # the loss is CE + aux


@pytest.mark.parametrize("arch,prompt", [("deepseek-v3-671b", 9), ("arctic-480b", 12)])
def test_prefill_caches_and_decode_track_jax(arch, prompt, rng):
    """Prefill logits and caches (MLA's latent in slots 0..P-1; arctic's
    GQA ring), then 4 greedy decode steps (MoE at one token a row)."""
    jcfg, tcfg = _configs(arch)
    jp, tp = _carry(jcfg, tcfg)
    x = rng.integers(0, jcfg.vocab_size, size=(2, prompt)).astype(np.int32)
    max_len = prompt + 4
    jlog, jc = jt.prefill(jp, jcfg, jnp.asarray(x), max_len)
    tlog, tc = tt.prefill(tp, tcfg, torch.from_numpy(x), max_len)
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), **F32)
    _assert_trees_close(jc, tc, **F32)
    _assert_trees_close(jt.init_decode_caches(jp, jcfg, 2, max_len), tt.init_decode_caches(tp, tcfg, 2, max_len))
    tok = np.asarray(jnp.argmax(jlog, axis=-1)).astype(np.int32)
    for t in range(4):
        pos = np.full((2,), prompt + t, np.int32)
        jlog, jc = jt.decode_step(jp, jcfg, jc, jnp.asarray(tok), jnp.asarray(pos))
        tlog, tc = tt.decode_step(tp, tcfg, tc, torch.from_numpy(tok), torch.from_numpy(pos))
        np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), **F32)
        tok = np.asarray(jnp.argmax(jlog, axis=-1)).astype(np.int32)
    _assert_trees_close(jc, tc, **F32)


def test_mla_decode_matches_a_longer_prefill(rng):
    """The absorbed decode of token P after prefill(P) gives prefill(P+1)'s
    last logits (latent-space scores against the full-sequence MLA)."""
    _, tcfg = _configs("deepseek-v3-671b")
    params = tt.init_params(torch.Generator().manual_seed(4), tcfg)
    x = torch.from_numpy(rng.integers(0, tcfg.vocab_size, size=(2, 11)).astype(np.int32))
    _, caches = tt.prefill(params, tcfg, x[:, :10], 16)
    got, _ = tt.decode_step(params, tcfg, caches, x[:, 10], torch.full((2,), 10, dtype=torch.int32))
    want, _ = tt.prefill(params, tcfg, x, 16)
    np.testing.assert_allclose(got.numpy(), want.numpy(), **F32)


def _stacked(trees):
    leaves, spec = tree_flatten(trees[0])
    others = [tree_flatten(t)[0] for t in trees[1:]]
    return tree_unflatten([torch.stack([leaf, *(o[i] for o in others)]) for i, leaf in enumerate(leaves)], spec)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_client_grads_of_ce_plus_aux_track_jax_without_a_batching_fallback(arch, rng):
    """The engine's ``grad(vmap(loss))`` over two clients: losses and every
    gradient leaf (the router's through the aux loss and the gates) against
    ``jax.grad`` of JAX's loss summed over clients, and no warning (torch
    warns when an op has no batching rule and falls back to a per-client
    loop)."""
    jcfg, tcfg = _configs(arch)
    trees = [_carry(jcfg, tcfg, seed) for seed in (0, 1)]
    jparams = jax.tree.map(lambda *x: jnp.stack(x), *(j for j, _ in trees))
    tparams = _stacked([t for _, t in trees])
    x = rng.integers(0, jcfg.vocab_size, size=(2, 2, 8)).astype(np.int32)
    y = rng.integers(0, jcfg.vocab_size, size=(2, 2, 8)).astype(np.int32)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        grads, losses = hierfavg._client_grads(tt.make_loss_fn(tcfg), None)(
            tparams, {"inputs": torch.from_numpy(x), "targets": torch.from_numpy(y)}, None)
    jloss = jt.make_loss_fn(jcfg)
    per_client = jax.vmap(lambda p, xi, yi: jloss(p, {"inputs": xi, "targets": yi}, None))
    want = jax.grad(lambda p: jnp.sum(per_client(p, jnp.asarray(x), jnp.asarray(y))))(jparams)
    np.testing.assert_allclose(losses.numpy(), np.asarray(per_client(jparams, jnp.asarray(x), jnp.asarray(y))),
                               **F32)
    want = {jax.tree_util.keystr(path): np.asarray(leaf) for path, leaf in jax.tree_util.tree_leaves_with_path(want)}
    got = tree_flatten_with_path(grads)[0]
    assert len(got) == len(want)
    for path, leaf in got:
        w = want["".join(f"['{k.key}']" for k in path)]
        np.testing.assert_allclose(leaf.numpy(), w, rtol=0, atol=1e-5 * float(np.abs(w).max()), err_msg=str(path))
    assert float(np.abs(want["['blocks']['b0']['moe']['router']"]).max()) > 0
