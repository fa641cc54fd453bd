"""K7 flash attention: the port's plain version against the JAX Pallas
kernel (interpret mode, as tests/test_kernels.py runs it) and its oracle
``attention_ref``, on the same numpy inputs; the GQA/MQA layout against
JAX's ``causal_attention``; the wrappers' checks; and, on a GPU, the CUDA
kernel against the plain version (this file runs on the card with
``-m cuda``, where JAX is not installed).

Tolerances: against JAX, ``atol=3e-4`` in f32 and ``4e-2`` in bf16, the
JAX kernel test's own. On the card the kernel and the plain version sum
in another order: ``atol=1e-5`` in f32 (|out| <= 4). In bf16 the kernel
runs on the tensor cores and rounds the probabilities to bf16 for the PV
product, as the layer code does, while the plain version keeps them in f32:
``fa.bf16_tolerance`` per element (1e-5 + 2^-7 / (1 - 2^-8) of the
attention over |v| + one bf16 ulp of the larger result), and the RMS error
within ``BF16_RMS_REL`` of the output's RMS (bf16 rounding alone gives
about 2e-3). The layer code's own tiled scheme is held to both on the CPU,
and a window one key too wide fails both.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops as tops
from repro_torch.models.layers import _repeat_kv, chunked_causal_attention

try:  # the card's machine has no JAX; there only the tests marked cuda run (-m cuda)
    import jax.numpy as jnp

    from repro.kernels import ops as jops
    from repro.kernels import ref as jref
    from repro.models import layers as jlayers

    jops.set_interpret(True)
except ImportError:
    jnp = jops = jref = jlayers = None

JAX_CASES = [(128, 0), (200, 0), (256, 33), (120, 64)]  # tests/test_kernels.py
_TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
_TOL = {"float32": 3e-4, "bfloat16": 4e-2}
BF16_RMS_REL = 5e-3


def _qkv(rng, shape_q, shape_kv, dtype):
    q = rng.normal(size=shape_q).astype(np.float32)
    k = rng.normal(size=shape_kv).astype(np.float32)
    v = rng.normal(size=shape_kv).astype(np.float32)
    jx = [jnp.asarray(a, dtype) for a in (q, k, v)]
    tx = [torch.from_numpy(np.array(a.astype(jnp.float32))).to(_TDT[dtype]) for a in jx]  # the same rounded values
    return jx, tx


@pytest.mark.parametrize("s,window", JAX_CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_tracks_the_pallas_kernel_and_the_oracle(rng, s, window, dtype):
    (jq, jk, jv), (tq, tk, tv) = _qkv(rng, (3, s, 64), (3, s, 64), dtype)
    pallas = jops.flash_attention(jq, jk, jv, causal=True, window=window, block_q=64, block_k=64)
    oracle = jref.attention_ref(jq, jk, jv, causal=True, window=window)
    got = tops.flash_attention(tq, tk, tv, causal=True, window=window)  # CPU: the plain version
    assert got.dtype == _TDT[dtype] and got.shape == (3, s, 64)
    for want in (pallas, oracle):
        np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), atol=_TOL[dtype])


@pytest.mark.parametrize("causal,window", [(False, 0), (False, 16), (True, 1)])
def test_plain_tracks_the_oracle_off_the_causal_default(rng, causal, window):
    (jq, jk, jv), (tq, tk, tv) = _qkv(rng, (2, 72, 32), (2, 72, 32), "float32")
    want = jref.attention_ref(jq, jk, jv, causal=causal, window=window)
    got = tops.flash_attention(tq, tk, tv, causal=causal, window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=3e-4)


def test_a_row_with_no_visible_key_is_zero():
    # more queries than keys, not causal, a window: late queries see no key
    q, k, v = torch.randn(1, 40, 1, 16), torch.randn(1, 8, 1, 16), torch.randn(1, 8, 1, 16)
    out = fa.attention_plain(q, k, v, causal=False, window=10)
    assert torch.equal(out[:, 17:], torch.zeros_like(out[:, 17:]))
    assert bool((out[:, :17].abs().sum(-1) > 0).all())


@pytest.mark.parametrize("h,hkv,hd,window", [(4, 2, 16, 0), (8, 1, 32, 8), (4, 1, 256, 0), (6, 3, 64, 5)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gqa_layout_tracks_jax(rng, h, hkv, hd, window, dtype):
    """The model's layout: q (B,S,H,hd) against un-replicated k/v
    (B,S,Hkv,hd); query head h reads KV head h // (H/Hkv). Held against the
    oracle on the folded (BH, S, hd) layout with the KV heads repeated, and
    against JAX's GQA-native ``causal_attention``."""
    B, S = 2, 48
    (jq, jk, jv), (tq, tk, tv) = _qkv(rng, (B, S, h, hd), (B, S, hkv, hd), dtype)
    got = fa.attention(tq, tk, tv, causal=True, window=window)
    assert got.shape == (B, S, h, hd) and got.dtype == _TDT[dtype]

    def fold(x):  # (B,S,H,hd) -> (B*H, S, hd)
        return jnp.transpose(x, (0, 2, 1, 3)).reshape(B * x.shape[2], S, hd)

    g = h // hkv
    oracle = jref.attention_ref(fold(jq), fold(jnp.repeat(jk, g, axis=2)), fold(jnp.repeat(jv, g, axis=2)),
                                causal=True, window=window)
    oracle = jnp.transpose(oracle.reshape(B, h, S, hd), (0, 2, 1, 3))
    np.testing.assert_allclose(got.float().numpy(), np.asarray(oracle, np.float32), atol=_TOL[dtype])
    pos = jnp.broadcast_to(jnp.arange(S, dtype=jnp.int32), (B, S))
    layer = jlayers.causal_attention(jq, jk, jv, q_positions=pos, kv_positions=pos, window=window)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(layer, np.float32), atol=_TOL[dtype])
    # the same as the repeated KV heads of the layers' ``_repeat_kv``, which K7 never builds
    repeated = fa.attention(tq, _repeat_kv(tk, g), _repeat_kv(tv, g), causal=True, window=window)
    torch.testing.assert_close(got, repeated, rtol=0, atol=1e-6)


def test_wrappers_check_their_inputs():
    q, k = torch.zeros(2, 8, 4, 16), torch.zeros(2, 8, 3, 16)
    with pytest.raises(ValueError, match="multiple of Hkv"):
        fa.attention(q, k, k)
    with pytest.raises(ValueError, match="share a dtype"):
        fa.attention(q, q.double(), q)
    with pytest.raises(ValueError, match=r"\(B,Sq,H,hd\)"):
        fa.attention(q[0], k[0], k[0])
    with pytest.raises(ValueError, match=r"\(BH, S, d\)"):
        tops.flash_attention(q, q, q)
    meta = torch.empty(2, 8, 4, 16, device="meta")
    with pytest.raises(ValueError, match="CPU .* or CUDA"):
        fa.attention(meta, meta, meta)
    assert fa.LAUNCHES == {"flash_attention": 0}  # the CPU never launches the kernel


def _rms_rel(got, want):
    return float((got.float() - want.float()).pow(2).mean().sqrt() / want.float().pow(2).mean().sqrt())


def _layer_code_tiles(q, k, v, window):
    """The layer code's chunked attention at 64 x 64 tiles: a running max,
    P rounded to bf16 per tile, l from the rounded P (K7's bf16 scheme)."""
    pos = torch.arange(q.shape[1], dtype=torch.int32).expand(q.shape[0], q.shape[1])
    return chunked_causal_attention(q, k, v, q_positions=pos, kv_positions=pos, window=window,
                                    chunk_q=64, chunk_k=64)


def _bf16_qkv(rng, b, s, h, hkv, hd):
    return (torch.from_numpy(rng.normal(size=(b, s, n, hd)).astype(np.float32)).to(torch.bfloat16)
            for n in (h, hkv, hkv))


@pytest.mark.parametrize("hd", [64, 256])
@pytest.mark.parametrize("window", [0, 100])
def test_bf16_tolerance_holds_for_the_layer_codes_tiled_scheme(rng, hd, window):
    """On bf16 inputs the layer code's tiled scheme stays within
    ``bf16_tolerance`` of the f32 oracle ``attention_plain``, element by
    element, and within ``BF16_RMS_REL`` in RMS."""
    q, k, v = _bf16_qkv(rng, 2, 256, 4, 1, hd)
    tiled = _layer_code_tiles(q, k, v, window)
    want = fa.attention_plain(q, k, v, causal=True, window=window)
    diff = (tiled.float() - want.float()).abs()
    assert tiled.dtype == torch.bfloat16 and bool(diff.max() > 0)  # the rounding shows
    tol = fa.bf16_tolerance(q, k, v, tiled, want, 1e-5, causal=True, window=window)
    assert bool((diff <= tol).all()), float((diff / tol).max())
    assert _rms_rel(tiled, want) <= BF16_RMS_REL


@pytest.mark.parametrize("hd,s,window", [(64, 2048, 1024), (256, 1024, 512)])
def test_bf16_tolerance_catches_a_window_one_key_too_wide(rng, hd, s, window):
    """A control: one key leaked at the window's edge of rows that each
    average up to ``window`` keys fails both the per-element bound and the
    RMS limit; the same scheme with the right window passes both."""
    q, k, v = _bf16_qkv(rng, 1, s, 2, 1, hd)
    want = fa.attention_plain(q, k, v, causal=True, window=window)
    for w, sound in ((window, True), (window + 1, False)):
        got = _layer_code_tiles(q, k, v, w)
        tol = fa.bf16_tolerance(q, k, v, got, want, 1e-5, causal=True, window=window)
        within = bool(((got.float() - want.float()).abs() <= tol).all())
        assert within == sound, (w, float(((got.float() - want.float()).abs() / tol).max()))
        assert (_rms_rel(got, want) <= BF16_RMS_REL) == sound, (w, _rms_rel(got, want))


# -- on the card: K7 against its plain version -----------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("b,s,h,hkv,hd,window", [
    (3, 200, 1, 1, 64, 0), (3, 256, 1, 1, 64, 33), (2, 130, 4, 2, 16, 0), (1, 300, 16, 1, 256, 128),
    (2, 77, 6, 3, 96, 5), (1, 1100, 8, 2, 128, 0), (1, 700, 4, 1, 256, 100), (1, 150, 2, 1, 33, 0),
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_matches_plain_on_gpu(cuda, b, s, h, hkv, hd, window, dtype):
    gen = torch.Generator(device=cuda).manual_seed(0)
    q = torch.randn(b, s, h, hd, generator=gen, device=cuda).to(dtype)
    k = torch.randn(b, s, hkv, hd, generator=gen, device=cuda).to(dtype)
    v = torch.randn(b, s, hkv, hd, generator=gen, device=cuda).to(dtype)
    before = fa.LAUNCHES["flash_attention"]
    got = fa.attention(q, k, v, causal=True, window=window)
    again = fa.attention(q, k, v, causal=True, window=window)
    want = fa.attention_plain(q, k, v, causal=True, window=window)
    torch.cuda.synchronize()
    assert fa.LAUNCHES["flash_attention"] == before + 2
    assert torch.equal(got, again)
    diff = (got.float() - want.float()).abs()
    if dtype == torch.float32:
        assert bool((diff <= 1e-5).all()), float(diff.max())
    else:
        tol = fa.bf16_tolerance(q, k, v, got, want, 1e-5, causal=True, window=window)
        assert bool((diff <= tol).all()), float((diff / tol).max())
        assert _rms_rel(got, want) <= BF16_RMS_REL
