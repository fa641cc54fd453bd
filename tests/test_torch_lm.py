"""The port's LM stack (configs, layers, RG-LRU, decoder stack, prefill and
cached decode) against the JAX package, on the CPU.

The JAX init is carried across with ``models.params_from_numpy`` and the
same numpy inputs go to both. Tolerances: f32 ``rtol=atol=1e-5`` (|logits|
<= 4; the two frameworks sum in other orders, measured <= 3e-6); bf16
``atol=0.125``, eight bf16 ulps at |logits| in [2, 4): bf16 rounds after
each operation, at other places in the two frameworks (measured <= 0.08).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._pytree import tree_flatten, tree_flatten_with_path, tree_map, tree_unflatten

from repro.configs import base as jbase
from repro.configs import registry as jreg
from repro.models import layers as jlayers
from repro.models import recurrent as jrec
from repro.models import transformer as jt
from repro_torch import models as tmodels
from repro_torch.configs import base as tbase
from repro_torch.configs import registry as treg
from repro_torch.core import hierfavg
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import rglru_scan as trg
from repro_torch.models import layers as tlayers
from repro_torch.models import recurrent as trec
from repro_torch.models import transformer as tt

F32 = dict(rtol=1e-5, atol=1e-5)
BF16_ATOL = 0.125
DENSE_AND_HYBRID = ["granite-3-2b", "yi-9b", "deepseek-7b", "recurrentgemma-9b", "internvl2-2b", "musicgen-medium"]


def _configs(arch, **changes):
    j, t = jreg.get_smoke(arch), treg.get_smoke(arch)
    if changes:
        j, t = dataclasses.replace(j, **changes), dataclasses.replace(t, **changes)
    return j, t


def _carry(jcfg, tcfg, seed=0):
    """JAX init -> (JAX params, the port's tree of the same weights),
    checked against the port's own init for names, shapes and dtypes."""
    jp = jt.init_params(jax.random.PRNGKey(seed), jcfg)
    like = tt.init_params(torch.Generator().manual_seed(seed), tcfg)
    return jp, tmodels.params_from_numpy(jax.device_get(jp), "cpu", like=like)


def _inputs(cfg, rng, b, s):
    if cfg.embed_inputs:
        return rng.integers(0, cfg.vocab_size, size=(b, s)).astype(np.int32)
    return rng.normal(size=(b, s, cfg.d_model)).astype(np.float32)


def _np(x):
    return np.array(x.astype(jnp.float32)) if isinstance(x, jax.Array) else x.detach().float().numpy()


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


# -- configs ------------------------------------------------------------------------


@pytest.mark.parametrize("arch", list(jreg.ARCH_IDS) + ["lm-100m"])
def test_configs_resolve_to_jax_fields_and_param_counts(arch):
    j, t = jreg.get_config(arch), treg.get_config(arch)
    assert dataclasses.asdict(j) == dataclasses.asdict(t)
    assert tbase.param_count(t) == jbase.param_count(j)
    assert tbase.active_param_count(t) == jbase.active_param_count(j)
    assert str(t.dtype()) == f"torch.{jnp.dtype(j.param_dtype).name}"
    assert [dataclasses.astuple(x) for x in t.input_shapes] == [dataclasses.astuple(x) for x in j.input_shapes]
    assert t.skipped_shapes == j.skipped_shapes
    assert t.fed.hierarchy().num_clients == j.fed.hierarchy().num_clients
    ts, js = t.fed.schedule(), j.fed.schedule()
    assert (ts.kappa1, ts.kappa2, ts.kappas) == (js.kappa1, js.kappa2, js.kappas)
    if arch != "lm-100m":
        assert dataclasses.asdict(jreg.get_smoke(arch)) == dataclasses.asdict(treg.get_smoke(arch))


def test_registry_ids_and_the_full_width_counts():
    assert treg.ARCH_IDS == jreg.ARCH_IDS
    assert tbase.param_count(treg.get_config("recurrentgemma-9b")) == 9_572_462_592
    assert tbase.param_count(treg.get_config("lm-100m")) == 125_848_320
    assert tbase.param_count(treg.get_config("xlstm-350m")) == 480_633_856
    with pytest.raises(KeyError, match="lm-100m"):
        treg.get_config("no-such-arch")


@pytest.mark.parametrize("name,want", [("float32", torch.float32), ("bfloat16", torch.bfloat16),
                                       ("float", torch.float64), ("half", torch.float16)])
def test_arch_dtype_parses_names_like_jnp(name, want):
    cfg = dataclasses.replace(treg.get_smoke("yi-9b"), param_dtype=name)
    assert cfg.dtype() == want
    assert jnp.dtype(name).name == str(want).replace("torch.", "")


# -- init --------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ["granite-3-2b", "yi-9b", "recurrentgemma-9b", "xlstm-350m", "deepseek-v3-671b",
                                  "arctic-480b"])
def test_init_params_has_the_jax_tree(arch):
    jcfg, tcfg = _configs(arch)
    shapes = jax.eval_shape(lambda: jt.init_params(jax.random.PRNGKey(0), jcfg))
    got = tt.init_params(torch.Generator().manual_seed(0), tcfg)
    flat_j = {jax.tree_util.keystr(p): v for p, v in jax.tree_util.tree_leaves_with_path(shapes)}
    flat_t = {jax.tree_util.keystr(p): v for p, v in jax.tree_util.tree_leaves_with_path(got)}
    assert sorted(flat_j) == sorted(flat_t)
    for k, v in flat_j.items():
        assert tuple(flat_t[k].shape) == tuple(v.shape), k
        assert str(flat_t[k].dtype) == f"torch.{v.dtype}", k
    assert sum(v.numel() for v in flat_t.values()) == tbase.param_count(tcfg)
    again = tt.init_params(torch.Generator().manual_seed(0), tcfg)
    assert all(torch.equal(flat_t[k], v) for k, v in
               {jax.tree_util.keystr(p): v for p, v in jax.tree_util.tree_leaves_with_path(again)}.items())


def test_init_scales_follow_jax():
    cfg = dataclasses.replace(treg.get_smoke("recurrentgemma-9b"), d_model=256, vocab_size=512)
    p = tt.init_params(torch.Generator().manual_seed(1), cfg)
    assert abs(float(p["embed"].std()) - 1.0) < 0.02
    assert abs(float(p["lm_head"].std()) - 256 ** -0.5) < 0.002
    assert abs(float(p["blocks"]["b0"]["rnn"]["conv"].std()) - 0.5) < 0.05
    lam = p["blocks"]["b0"]["rnn"]["lambda"]
    assert lam.dtype == torch.float32 and 0.3 <= float(lam.min()) and float(lam.max()) <= 0.8
    assert torch.equal(p["final_norm"], torch.ones(256))


def test_params_from_numpy_refuses_a_wrong_tree_and_carries_bf16():
    jcfg, tcfg = _configs("granite-3-2b", param_dtype="bfloat16")
    jp, tp = _carry(jcfg, tcfg)
    assert tp["embed"].dtype == torch.bfloat16
    np.testing.assert_array_equal(tp["embed"].float().numpy(), np.asarray(jp["embed"].astype(jnp.float32)))
    like = tt.init_params(torch.Generator().manual_seed(0), tcfg)
    bad = dict(jax.device_get(jp))
    bad.pop("final_norm")
    with pytest.raises(ValueError, match="names"):
        tmodels.params_from_numpy(bad, like=like)
    bad = dict(jax.device_get(jp), lm_head=np.zeros((3, 3), np.float32))
    with pytest.raises(ValueError, match="lm_head"):
        tmodels.params_from_numpy(bad, like=like)


# -- layers ------------------------------------------------------------------------


def test_rmsnorm_and_rope_track_jax(rng):
    x = rng.normal(size=(2, 7, 3, 16)).astype(np.float32)
    scale = rng.normal(size=(16,)).astype(np.float32)
    pos = rng.integers(0, 5000, size=(2, 7)).astype(np.int32)
    np.testing.assert_allclose(tlayers.rmsnorm(torch.from_numpy(x), torch.from_numpy(scale)).numpy(),
                               np.asarray(jlayers.rmsnorm(jnp.asarray(x), jnp.asarray(scale))), **F32)
    # |angle| up to 5000 rad: f32 sin/cos of large arguments differ by a few ulp of the angle
    np.testing.assert_allclose(tlayers.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), 10000.0).numpy(),
                               np.asarray(jlayers.apply_rope(jnp.asarray(x), jnp.asarray(pos), 10000.0)),
                               rtol=1e-5, atol=5e-5)


@pytest.mark.parametrize("window", [0, 5])
def test_attention_with_cache_slots_tracks_jax(rng, window):
    """``causal_attention`` on arbitrary positions with a slot mask (the
    decode step's call), GQA 4 on 2."""
    B, Sq, Sk, H, Hkv, hd = 2, 3, 10, 4, 2, 8
    q = rng.normal(size=(B, Sq, H, hd)).astype(np.float32)
    k = rng.normal(size=(B, Sk, Hkv, hd)).astype(np.float32)
    v = rng.normal(size=(B, Sk, Hkv, hd)).astype(np.float32)
    qpos = np.array([[7, 8, 9], [3, 4, 5]], np.int32)
    kpos = rng.permutation(np.arange(-1, Sk - 1)).astype(np.int32)[None].repeat(B, 0)
    valid = kpos >= 0
    want = jlayers.causal_attention(*(jnp.asarray(a) for a in (q, k, v)), q_positions=jnp.asarray(qpos),
                                    kv_positions=jnp.asarray(kpos), window=window, kv_valid=jnp.asarray(valid))
    got = tlayers.causal_attention(*(torch.from_numpy(a) for a in (q, k, v)), q_positions=torch.from_numpy(qpos),
                                   kv_positions=torch.from_numpy(kpos), window=window,
                                   kv_valid=torch.from_numpy(valid))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)


@pytest.mark.parametrize("window", [0, 3, 6])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_chunked_attention_tracks_jax(rng, window, dtype):
    B, S, H, Hkv, hd = 2, 16, 4, 1, 8
    arrs = [rng.normal(size=shape).astype(np.float32) for shape in ((B, S, H, hd), (B, S, Hkv, hd), (B, S, Hkv, hd))]
    jx = [jnp.asarray(a, dtype) for a in arrs]
    tx = [torch.from_numpy(_np(a)).to(getattr(torch, dtype)) for a in jx]
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S))
    want = jlayers.chunked_causal_attention(*jx, q_positions=jnp.asarray(pos), kv_positions=jnp.asarray(pos),
                                            window=window, chunk_q=4, chunk_k=4)
    got = tlayers.chunked_causal_attention(*tx, q_positions=torch.from_numpy(pos.copy()),
                                           kv_positions=torch.from_numpy(pos.copy()), window=window,
                                           chunk_q=4, chunk_k=4)
    assert got.dtype == getattr(torch, dtype)
    tol = F32 if dtype == "float32" else dict(atol=4e-2)  # the JAX kernel test's bf16 tolerance
    np.testing.assert_allclose(_np(got), _np(want), **tol)
    with pytest.raises(ValueError, match="divide"):
        tlayers.chunked_causal_attention(*tx, q_positions=torch.from_numpy(pos.copy()),
                                         kv_positions=torch.from_numpy(pos.copy()), chunk_q=5, chunk_k=5)


def test_rglru_block_and_step_track_jax(rng):
    jcfg, tcfg = _configs("recurrentgemma-9b")
    jp = jrec.init_rglru(jax.random.PRNGKey(3), jcfg)
    tp = tmodels.params_from_numpy(jax.device_get(jp))
    x = rng.normal(size=(2, 9, jcfg.d_model)).astype(np.float32)
    np.testing.assert_allclose(trec.rglru_sequence(tp, torch.from_numpy(x), tcfg)[0].numpy(),
                               np.asarray(jrec.rglru_apply(jp, jnp.asarray(x), jcfg)), **F32)
    jstate = jrec.rglru_init_state(jcfg, 2, jnp.float32)
    tstate = trec.rglru_init_state(tcfg, 2, torch.float32)
    for t in range(4):
        jy, jstate = jrec.rglru_step(jp, jnp.asarray(x[:, t:t + 1]), jstate, jcfg)
        ty, tstate = trec.rglru_step(tp, torch.from_numpy(x[:, t:t + 1]), tstate, tcfg)
        np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **F32)
    _assert_trees_close(jstate, tstate, **F32)


# -- the decoder stack ---------------------------------------------------------------


@pytest.mark.parametrize("arch", DENSE_AND_HYBRID)
def test_forward_and_loss_track_jax(arch, rng):
    jcfg, tcfg = _configs(arch)
    jp, tp = _carry(jcfg, tcfg)
    x = _inputs(jcfg, rng, 2, 16)
    targets = rng.integers(0, jcfg.vocab_size, size=(2, 16)).astype(np.int32)
    jl, jaux = jt.forward(jp, jcfg, jnp.asarray(x))
    tl = tt.forward(tp, tcfg, torch.from_numpy(x))
    assert tl.shape == (2, 16, tcfg.vocab_size) and tl.dtype == torch.float32 and float(jaux) == 0.0
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **F32)
    jbatch = {"inputs": jnp.asarray(x), "targets": jnp.asarray(targets)}
    tbatch = {"inputs": torch.from_numpy(x), "targets": torch.from_numpy(targets)}
    jloss = jt.make_loss_fn(jcfg)(jp, jbatch, jax.random.PRNGKey(0))
    tloss = tt.make_loss_fn(tcfg)(tp, tbatch, None)
    np.testing.assert_allclose(float(tloss), float(jloss), **F32)
    mask = (rng.random((2, 16)) > 0.3).astype(np.float32)
    np.testing.assert_allclose(float(tt.cross_entropy(tl, tbatch["targets"], torch.from_numpy(mask))),
                               float(jt.cross_entropy(jl, jbatch["targets"], jnp.asarray(mask))), **F32)


@pytest.mark.parametrize("arch", ["granite-3-2b", "recurrentgemma-9b"])
def test_chunked_forward_tracks_jax(arch, rng):
    """``attn_chunk`` 4 at S 16: every attention layer takes the chunked
    path (recurrentgemma's window 8 skips the chunks behind it)."""
    jcfg, tcfg = _configs(arch, attn_chunk=4)
    jp, tp = _carry(jcfg, tcfg)
    x = _inputs(jcfg, rng, 2, 16)
    jl, _ = jt.forward(jp, jcfg, jnp.asarray(x))
    tl = tt.forward(tp, tcfg, torch.from_numpy(x))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **F32)


@pytest.mark.parametrize("arch", ["granite-3-2b", "recurrentgemma-9b"])
@pytest.mark.parametrize("chunk", [0, 4])
def test_bf16_forward_tracks_jax(arch, chunk, rng):
    jcfg, tcfg = _configs(arch, param_dtype="bfloat16", compute_dtype="bfloat16", attn_chunk=chunk)
    jp, tp = _carry(jcfg, tcfg)
    x = _inputs(jcfg, rng, 2, 16)
    jl, _ = jt.forward(jp, jcfg, jnp.asarray(x))
    tl = tt.forward(tp, tcfg, torch.from_numpy(x))
    assert tl.dtype == torch.bfloat16
    np.testing.assert_allclose(_np(tl), _np(jl), atol=BF16_ATOL)


@pytest.mark.parametrize("arch,prompt", [("recurrentgemma-9b", 16), ("recurrentgemma-9b", 5),
                                         ("granite-3-2b", 12), ("internvl2-2b", 9)])
def test_prefill_logits_and_caches_track_jax(arch, prompt, rng):
    """Prefill logits and every cache leaf (k, v, pos; h, conv); a prompt
    of 16 wraps recurrentgemma-smoke's 8-slot rings."""
    jcfg, tcfg = _configs(arch)
    jp, tp = _carry(jcfg, tcfg)
    x = _inputs(jcfg, rng, 2, prompt)
    max_len = prompt + 8
    jlog, jc = jt.prefill(jp, jcfg, jnp.asarray(x), max_len)
    tlog, tc = tt.prefill(tp, tcfg, torch.from_numpy(x), max_len)
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), **F32)
    _assert_trees_close(jc, tc, **F32)
    empty = tt.init_decode_caches(tp, tcfg, 2, max_len)
    _assert_trees_close(jt.init_decode_caches(jp, jcfg, 2, max_len), empty, **F32)


@pytest.mark.parametrize("arch", ["recurrentgemma-9b", "yi-9b"])
def test_decode_past_the_window_tracks_jax(arch, rng):
    """Prefill 6 tokens, then 10 greedy decode steps: recurrentgemma-smoke's
    window of 8 wraps its rings after 2 steps."""
    jcfg, tcfg = _configs(arch)
    jp, tp = _carry(jcfg, tcfg)
    P, steps = 6, 10
    x = _inputs(jcfg, rng, 2, P)
    jlog, jc = jt.prefill(jp, jcfg, jnp.asarray(x), P + steps)
    tlog, tc = tt.prefill(tp, tcfg, torch.from_numpy(x), P + steps)
    tok = np.asarray(jnp.argmax(jlog, axis=-1)).astype(np.int32)
    for t in range(steps):
        pos = np.full((2,), P + t, np.int32)
        jlog, jc = jt.decode_step(jp, jcfg, jc, jnp.asarray(tok), jnp.asarray(pos))
        tlog, tc = tt.decode_step(tp, tcfg, tc, torch.from_numpy(tok), torch.from_numpy(pos))
        np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), **F32)
        tok = np.asarray(jnp.argmax(jlog, axis=-1)).astype(np.int32)
    _assert_trees_close(jc, tc, **F32)
    if arch == "recurrentgemma-9b":  # every ring slot was overwritten at least once
        assert int(tc["blocks"]["b2"]["pos"].min()) >= P + steps - jcfg.window


def test_decode_matches_a_longer_prefill(rng):
    """Decoding token P after prefill(P) gives prefill(P+1)'s last logits."""
    _, tcfg = _configs("recurrentgemma-9b")
    params = tt.init_params(torch.Generator().manual_seed(4), tcfg)
    x = _inputs(tcfg, rng, 2, 13)
    _, caches = tt.prefill(params, tcfg, torch.from_numpy(x[:, :12]), 16)
    got, _ = tt.decode_step(params, tcfg, caches, torch.from_numpy(x[:, 12]), torch.full((2,), 12, dtype=torch.int32))
    want, _ = tt.prefill(params, tcfg, torch.from_numpy(x), 16)
    np.testing.assert_allclose(got.numpy(), want.numpy(), **F32)


class _CudaLike(torch.Tensor):
    """A CPU tensor that reports ``is_cuda``, so the layers' choice between
    K7/K8 and their own code runs here; the kernels' wrappers, patched
    below, count the call and compute on the CPU."""

    @property
    def is_cuda(self):
        return True


@pytest.fixture
def kernel_calls(monkeypatch):
    calls = {"attention": 0, "rglru_scan": 0}

    def counted(name, fn):
        def call(*args, **kwargs):
            calls[name] += 1
            return fn(*args, **kwargs)
        return call

    monkeypatch.setattr(tfa, "attention", counted("attention", tfa.attention))
    monkeypatch.setattr(trg, "rglru_scan", counted("rglru_scan", trg.rglru_scan))
    return calls


def test_kernel_route_follows_autograd_and_positions(kernel_calls, rng):
    """On the card the layers take K7/K8 unless autograd would record the
    call (grad mode on and an input requiring grad) or the positions are
    given explicitly: grad mode alone, on by default, does not turn them
    away. The kernel route computes what the layer code computes."""
    _, tcfg = _configs("recurrentgemma-9b")
    params = tt.init_params(torch.Generator().manual_seed(5), tcfg)
    kinds = [kind for _, kind, _ in tt._layers(params, tcfg)]
    per_pass = {"attention": sum(k in tt.ATTN_KINDS for k in kinds), "rglru_scan": kinds.count("rglru")}
    assert per_pass["attention"] > 0 and per_pass["rglru_scan"] > 0
    card = tree_map(lambda t: t.as_subclass(_CudaLike), params)
    x = torch.from_numpy(_inputs(tcfg, rng, 2, 12)).as_subclass(_CudaLike)
    positions = torch.arange(12, dtype=torch.int32).expand(2, 12)

    def route(fn):
        for k in kernel_calls:
            kernel_calls[k] = 0
        out = fn()
        return {k: v // per_pass[k] for k, v in kernel_calls.items()}, out

    assert torch.is_grad_enabled()
    both, layer_code = dict(attention=1, rglru_scan=1), dict(attention=0, rglru_scan=0)
    seen, kern = route(lambda: tt.forward(card, tcfg, x))
    assert seen == both and kernel_calls == per_pass
    seen, plain = route(lambda: tt.forward(card, tcfg, x, positions=positions))
    assert seen == layer_code
    np.testing.assert_allclose(kern.as_subclass(torch.Tensor).detach().numpy(),
                               plain.as_subclass(torch.Tensor).detach().numpy(), **F32)
    seen, _ = route(lambda: tt.prefill(card, tcfg, x, 16))
    assert seen == both
    trained = tree_map(lambda t: t.detach().requires_grad_(), card)
    seen, _ = route(lambda: tt.forward(trained, tcfg, x))
    assert seen == layer_code
    with torch.no_grad():
        seen, _ = route(lambda: tt.forward(trained, tcfg, x))
    assert seen == both
    seen, _ = route(lambda: tt.forward(params, tcfg, x.as_subclass(torch.Tensor)))  # a CPU tensor
    assert seen == layer_code


def _stacked(trees):
    """One tree whose leaves stack the given trees' along a new client axis."""
    leaves, spec = tree_flatten(trees[0])
    others = [tree_flatten(t)[0] for t in trees[1:]]
    return tree_unflatten([torch.stack([leaf, *(o[i] for o in others)]) for i, leaf in enumerate(leaves)], spec)


@pytest.mark.parametrize("arch", ["granite-3-2b", "recurrentgemma-9b"])
def test_client_grads_under_torch_func_take_the_layer_code(arch, kernel_calls, monkeypatch, rng):
    """The engine's ``grad(vmap(loss))`` hands the layers functorch-wrapped
    tensors that report ``requires_grad=False``: with the card test forced
    true, the route must still take the layer code (no K7 / K8 call), and the
    gradients of two clients' LM losses match ``jax.grad`` of JAX's loss
    summed over clients within 1e-5 of each leaf's largest. The same forced
    route sends a plain forward to both kernels (the control)."""
    jcfg, tcfg = _configs(arch)
    monkeypatch.setattr(tlayers, "_on_card", lambda t: True)
    trees = [_carry(jcfg, tcfg, seed) for seed in (0, 1)]
    jparams = jax.tree.map(lambda *x: jnp.stack(x), *(j for j, _ in trees))
    tparams = _stacked([t for _, t in trees])
    x = np.stack([_inputs(jcfg, rng, 2, 8) for _ in range(2)])
    y = rng.integers(0, jcfg.vocab_size, size=(2, 2, 8)).astype(np.int32)

    grads, losses = hierfavg._client_grads(tt.make_loss_fn(tcfg), None)(
        tparams, {"inputs": torch.from_numpy(x), "targets": torch.from_numpy(y)}, None)
    assert kernel_calls == {"attention": 0, "rglru_scan": 0}

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

    kinds = [kind for _, kind, _ in tt._layers(trees[0][1], tcfg)]
    with torch.no_grad():
        tt.forward(trees[0][1], tcfg, torch.from_numpy(x[0]))
    assert kernel_calls == {"attention": sum(k in tt.ATTN_KINDS for k in kinds), "rglru_scan": kinds.count("rglru")}
