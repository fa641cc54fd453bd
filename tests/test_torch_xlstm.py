"""The port's xLSTM cells against the JAX package, on the CPU: the
stabilised chunkwise mLSTM (one chunk from a carry, the full sequence with
end padding, the recurrent step, the chunkwise form against a loop of
steps), the sequential sLSTM (full sequence and step), the xlstm-smoke
stack's forward, loss, prefill caches and decode, the prefill's
whole-chunk rule, and the engine's ``grad(vmap(loss))`` over two clients.

The JAX init is carried across with ``models.params_from_numpy`` and the
same numpy inputs go to both. Tolerances: f32 layer outputs and states
``rtol=1e-5`` and ``atol`` 1e-6 of the largest |value| (at least 1e-6);
the stack's logits and losses ``rtol=atol=1e-5`` (|logits| <= 4), as
``test_torch_lm.py`` holds the other stacks, and its cache states the
same with ``atol`` at least 1e-6 of the leaf's largest |value| (four
layers and six decode steps carry an sLSTM state 5.9e-6 apart, and the
sLSTM stabiliser m, a running log-domain sum, reaches 40 and sits 1.3e-5
apart: measured); gradients within 1e-5 of each leaf's largest.
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
from repro.models import recurrent as jrec
from repro.models import transformer as jt
from repro_torch import models as tmodels
from repro_torch.configs import registry as treg
from repro_torch.core import hierfavg
from repro_torch.models import recurrent as trec
from repro_torch.models import transformer as tt

F32 = dict(rtol=1e-5, atol=1e-5)


def _configs(**changes):
    j, t = jreg.get_smoke("xlstm-350m"), treg.get_smoke("xlstm-350m")
    return dataclasses.replace(j, **changes), dataclasses.replace(t, **changes)


def _close(got, want, err_msg=""):
    """rtol 1e-5, atol 1e-6 of max(1, max |want|)."""
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (err_msg, got.shape, want.shape)
    assert np.isfinite(got).all(), err_msg
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6 * max(1.0, float(np.abs(want).max())),
                               err_msg=err_msg)


def _close_trees(jtree, ttree, stack=False, exact=False):
    """Leaf by leaf: names and dtypes equal, values within ``_close`` (a
    layer's state), the stack's tolerance (``stack``) or equal (``exact``:
    an initial state, whose m of -1e30 would make a scaled atol vacuous)."""
    assert set(jtree) == set(ttree)
    for k in jtree:
        assert str(np.asarray(jtree[k]).dtype) == str(ttree[k].dtype).replace("torch.", ""), k
        if exact:
            np.testing.assert_array_equal(ttree[k].numpy(), np.asarray(jtree[k]), err_msg=k)
        elif stack:
            want = np.asarray(jtree[k])
            np.testing.assert_allclose(ttree[k].numpy(), want, err_msg=k, rtol=1e-5,
                                       atol=max(1e-5, 1e-6 * float(np.abs(want).max())))
        else:
            _close(ttree[k], jtree[k], k)


def _carry(jcfg, tcfg, seed=0):
    jp = jt.init_params(jax.random.PRNGKey(seed), jcfg)
    like = tt.init_params(torch.Generator().manual_seed(seed), tcfg)
    return jp, tmodels.params_from_numpy(jax.device_get(jp), "cpu", like=like)


def _cell(kind, seed=3):
    jcfg, tcfg = _configs()
    jinit, tinit = (jrec.init_mlstm, trec.init_mlstm) if kind == "mlstm" else (jrec.init_slstm, trec.init_slstm)
    jp = jinit(jax.random.PRNGKey(seed), jcfg)
    tp = tmodels.params_from_numpy(jax.device_get(jp), like=tinit(torch.Generator(), tcfg))
    return jcfg, tcfg, jp, tp


# -- mLSTM ----------------------------------------------------------------------------


@pytest.mark.parametrize("fresh", [True, False])
def test_mlstm_chunk_tracks_jax(fresh, rng):
    """One chunk of 8 from the initial carry (m = -1e30: the carry's weight
    exp(m + F_t - m_t) must underflow to 0, not give NaN) and from a drawn
    one."""
    B, H, W, dh = 2, 3, 8, 5
    q, k, v = (rng.normal(size=(B, H, W, dh)).astype(np.float32) for _ in range(3))
    i_log, f_log = (rng.normal(size=(B, H, W)).astype(np.float32) for _ in range(2))
    if fresh:
        carry = (np.zeros((B, H, dh, dh), np.float32), np.zeros((B, H, dh), np.float32),
                 np.full((B, H), -1e30, np.float32))
    else:
        carry = (rng.normal(size=(B, H, dh, dh)).astype(np.float32), rng.normal(size=(B, H, dh)).astype(np.float32),
                 rng.normal(size=(B, H)).astype(np.float32))
    jh, jc = jrec._mlstm_chunk(*(jnp.asarray(a) for a in (q, k, v, i_log, f_log)), tuple(map(jnp.asarray, carry)))
    th, tc = trec._mlstm_chunk(*(torch.from_numpy(a) for a in (q, k, v, i_log, f_log)),
                               tuple(map(torch.from_numpy, carry)))
    _close(th, jh, "h")
    for name, a, b in zip("Cnm", tc, jc):
        _close(a, b, name)


@pytest.mark.parametrize("seq", [5, 16, 21, 48])
def test_mlstm_sequence_tracks_jax(seq, rng):
    """Chunks of 16: 5 (one short chunk), 16, 48 (three), 21 (end-padded
    with i = -1e30 to 32)."""
    jcfg, tcfg, jp, tp = _cell("mlstm")
    x = rng.normal(size=(2, seq, jcfg.d_model)).astype(np.float32)
    y, state = trec.mlstm_sequence(tp, torch.from_numpy(x), tcfg)
    _close(y, jrec.mlstm_apply(jp, jnp.asarray(x), jcfg))
    assert state["C"].shape == (2, 4, 32, 32) and state["m"].dtype == torch.float32


def test_mlstm_step_tracks_jax_and_the_chunkwise_form_is_the_loop_of_steps(rng):
    """12 recurrent steps against JAX's step (y and state each step); the
    chunkwise sequence over 3 chunks of 4 gives the same outputs and the
    same final state as the loop of steps."""
    jcfg, tcfg, jp, tp = _cell("mlstm")
    tcfg4 = dataclasses.replace(tcfg, mlstm_chunk=4)
    x = rng.normal(size=(2, 12, jcfg.d_model)).astype(np.float32)
    jstate = jrec.mlstm_init_state(jcfg, 2, jnp.float32)
    tstate = trec.mlstm_init_state(tcfg, 2, torch.float32)
    _close_trees(jstate, tstate, exact=True)
    ys = []
    for t in range(12):
        jy, jstate = jrec.mlstm_step(jp, jnp.asarray(x[:, t:t + 1]), jstate, jcfg)
        ty, tstate = trec.mlstm_step(tp, torch.from_numpy(x[:, t:t + 1]), tstate, tcfg)
        _close(ty, jy, f"step {t}")
        _close_trees(jstate, tstate)
        ys.append(ty)
    y, state = trec.mlstm_sequence(tp, torch.from_numpy(x), tcfg4)
    _close(y, torch.cat(ys, dim=1).numpy())
    for k in state:
        _close(state[k], tstate[k].numpy(), k)


# -- sLSTM ----------------------------------------------------------------------------


def test_slstm_sequence_and_step_track_jax(rng):
    jcfg, tcfg, jp, tp = _cell("slstm")
    x = rng.normal(size=(2, 9, jcfg.d_model)).astype(np.float32)
    y, state = trec.slstm_sequence(tp, torch.from_numpy(x), tcfg)
    _close(y, jrec.slstm_apply(jp, jnp.asarray(x), jcfg))
    jstate = jrec.slstm_init_state(jcfg, 2, jnp.float32)
    tstate = trec.slstm_init_state(tcfg, 2, torch.float32)
    _close_trees(jstate, tstate, exact=True)
    for t in range(9):
        jy, jstate = jrec.slstm_step(jp, jnp.asarray(x[:, t:t + 1]), jstate, jcfg)
        ty, tstate = trec.slstm_step(tp, torch.from_numpy(x[:, t:t + 1]), tstate, tcfg)
        _close(ty, jy, f"step {t}")
        _close_trees(jstate, tstate)
    for k in state:  # the sequence's last state is the loop's
        _close(state[k], tstate[k].numpy(), k)


# -- the stack ------------------------------------------------------------------------


def test_init_forward_and_loss_track_jax(rng):
    jcfg, tcfg = _configs()
    jp, tp = _carry(jcfg, tcfg)
    assert sorted(tp["blocks"]["b3"]) == ["cell", "norm1"]  # no MLP: d_ff is 0
    assert tp["blocks"]["b3"]["cell"]["r_i"].dtype == torch.float32
    x = rng.integers(0, jcfg.vocab_size, size=(2, 40)).astype(np.int32)  # 40: end-padded to 48
    y = rng.integers(0, jcfg.vocab_size, size=(2, 40)).astype(np.int32)
    jl, jaux = jt.forward(jp, jcfg, jnp.asarray(x))
    tl, taux = tt.forward_with_aux(tp, tcfg, torch.from_numpy(x))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **F32)
    assert float(jaux) == float(taux) == 0.0
    jloss = jt.make_loss_fn(jcfg)(jp, {"inputs": jnp.asarray(x), "targets": jnp.asarray(y)}, None)
    tloss = tt.make_loss_fn(tcfg)(tp, {"inputs": torch.from_numpy(x), "targets": torch.from_numpy(y)}, None)
    np.testing.assert_allclose(float(tloss), float(jloss), **F32)


@pytest.mark.parametrize("prompt", [5, 16, 32])
def test_prefill_caches_and_decode_track_jax(prompt, rng):
    """Prompts of one short chunk, one chunk and two chunks: prefill logits
    and every state leaf (C, n, m; h, c, n, m), then 6 decode steps."""
    jcfg, tcfg = _configs()
    jp, tp = _carry(jcfg, tcfg)
    x = rng.integers(0, jcfg.vocab_size, size=(2, prompt)).astype(np.int32)
    jlog, jc = jt.prefill(jp, jcfg, jnp.asarray(x), prompt + 6)
    tlog, tc = tt.prefill(tp, tcfg, torch.from_numpy(x), prompt + 6)
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), **F32)
    for b in jc["blocks"]:
        _close_trees(jc["blocks"][b], tc["blocks"][b], stack=True)
    empty = tt.init_decode_caches(tp, tcfg, 2, prompt + 6)
    for b in empty["blocks"]:
        _close_trees(jt.init_decode_caches(jp, jcfg, 2, prompt + 6)["blocks"][b], empty["blocks"][b], exact=True)
    tok = np.asarray(jnp.argmax(jlog, axis=-1)).astype(np.int32)
    for t in range(6):
        pos = np.full((2,), prompt + t, np.int32)
        jlog, jc = jt.decode_step(jp, jcfg, jc, jnp.asarray(tok), jnp.asarray(pos))
        tlog, tc = tt.decode_step(tp, tcfg, tc, torch.from_numpy(tok), torch.from_numpy(pos))
        np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), **F32)
        tok = np.asarray(jnp.argmax(jlog, axis=-1)).astype(np.int32)
    for b in jc["blocks"]:
        _close_trees(jc["blocks"][b], tc["blocks"][b], stack=True)


def test_decode_matches_the_chunkwise_forward(rng):
    """Decoding token P after prefill(P) (P = 2 chunks) gives the last
    logits of ``forward`` over P + 1 tokens (end-padded chunks)."""
    _, tcfg = _configs()
    params = tt.init_params(torch.Generator().manual_seed(4), tcfg)
    x = torch.from_numpy(rng.integers(0, tcfg.vocab_size, size=(2, 33)).astype(np.int32))
    _, caches = tt.prefill(params, tcfg, x[:, :32], 40)
    got, _ = tt.decode_step(params, tcfg, caches, x[:, 32], torch.full((2,), 32, dtype=torch.int32))
    np.testing.assert_allclose(got.numpy(), tt.forward(params, tcfg, x)[:, -1].numpy(), **F32)


@pytest.mark.parametrize("prompt", [17, 20, 40])
def test_a_prompt_of_a_partial_chunk_past_the_first_is_refused_as_jax_fails(prompt, rng):
    """Past one chunk (16) a prompt must be a multiple of it: JAX's prefill
    fails at its replay's reshape; the port refuses the same prompts with a
    ValueError that names the rule."""
    jcfg, tcfg = _configs()
    jp, tp = _carry(jcfg, tcfg)
    x = rng.integers(0, jcfg.vocab_size, size=(1, prompt)).astype(np.int32)
    with pytest.raises(TypeError, match="reshape"):
        jt.prefill(jp, jcfg, jnp.asarray(x), prompt + 4)
    with pytest.raises(ValueError, match=rf"longer than mlstm_chunk=16 must be a multiple of it \(got {prompt}\)"):
        tt.prefill(tp, tcfg, torch.from_numpy(x), prompt + 4)


def _stacked(trees):
    leaves, spec = tree_flatten(trees[0])
    others = [tree_flatten(t)[0] for t in trees[1:]]
    return tree_unflatten([torch.stack([leaf, *(o[i] for o in others)]) for i, leaf in enumerate(leaves)], spec)


def test_client_grads_track_jax_without_a_batching_fallback(rng):
    """The engine's ``grad(vmap(loss))`` over two clients (sequence 20:
    two chunks, the second end-padded): losses and every gradient leaf
    against ``jax.grad``, with no warning (``torch.cummax`` and the sLSTM's
    loop batch without a per-client fallback)."""
    jcfg, tcfg = _configs()
    trees = [_carry(jcfg, tcfg, seed) for seed in (0, 1)]
    jparams = jax.tree.map(lambda *x: jnp.stack(x), *(j for j, _ in trees))
    tparams = _stacked([t for _, t in trees])
    x = rng.integers(0, jcfg.vocab_size, size=(2, 2, 20)).astype(np.int32)
    y = rng.integers(0, jcfg.vocab_size, size=(2, 2, 20)).astype(np.int32)
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
