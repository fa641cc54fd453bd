"""K4 quantize, K5 dequantize and K6 segment_dequant_mean against the JAX
package: the same seeded numpy inputs through the Pallas kernels (interpret
mode, as the JAX package's own tests run them) or their ``ref.py`` oracles
and through the port's entry points, which take the plain PyTorch versions
on CPU tensors.

Tolerances. K4's codes are bit-equal to the Pallas kernel's and the
oracle's. Its scales are bit-equal to the oracle run eagerly (``absmax /
127`` as an IEEE division, which the port and its CUDA kernel compute);
under ``jit`` XLA's CPU compiler turns that division by a constant into a
multiply by the reciprocal, so the interpreted Pallas kernel's scales may
sit one f32 ulp away, which the test allows and no more. K5 is bit-equal on
the same codes and scales. K6 agrees within ``atol=1e-6`` (the sums run in
another order than the oracle's one-hot matmuls); dead segments keep their
decoded rows bit for bit. On the card the kernels are held against their
plain versions in ``test_torch_kernels.py``, which imports no jax.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.fed import transport as jtp
from repro.kernels import ops as jops
from repro.kernels import ref
from repro_torch.fed import transport as ttp
from repro_torch.kernels import hier_aggregate as ha
from repro_torch.kernels import ops
from repro_torch.kernels import quantize as qz

jops.set_interpret(True)

SHAPES = [(37, 129), (8, 2048), (1000,), (3, 5, 7)]


def _t(x):
    return torch.from_numpy(np.array(x))


def _within_one_ulp(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return bool(np.all(np.abs(a - b) <= np.spacing(np.maximum(np.abs(a), np.abs(b)))))


# -- K4 / K5 -------------------------------------------------------------------


@pytest.mark.parametrize("shape", SHAPES, ids=str)
@pytest.mark.parametrize("qblock", [128, 256])
def test_quantize_int8_matches_jax(rng, shape, qblock):
    x = (rng.normal(size=shape) * 3.0).astype(np.float32)
    q, s, shp = ops.quantize_int8(_t(x), qblock)
    qk, sk, _ = jops.quantize_int8(jnp.asarray(x), qblock=qblock)  # Pallas, interpret
    qr, sr, _ = ref.quantize_ref(jnp.asarray(x), qblock=qblock)  # oracle, eager
    assert q.dtype == torch.int8 and shp == shape
    np.testing.assert_array_equal(q.numpy(), np.asarray(qk))
    np.testing.assert_array_equal(q.numpy(), np.asarray(qr))
    np.testing.assert_array_equal(s.numpy(), np.asarray(sr))
    assert s.shape == sk.shape and _within_one_ulp(s.numpy(), sk)
    # K5 on the same codes and scales: bit-equal to the Pallas kernel
    back = ops.dequantize_int8(_t(qk), _t(sk), shape)
    np.testing.assert_array_equal(back.numpy(), np.asarray(jops.dequantize_int8(qk, sk, shape)))
    own = ops.dequantize_int8(q, s, shp)
    assert float((own - _t(x)).abs().max()) <= float(s.max()) * 0.5 + 1e-6


@pytest.mark.parametrize("n,d,qblock", [(4, 700, 256), (8, 1024, 256), (20, 768, 128), (50, 10, 128), (3, 5, 1)])
def test_quantize_stacked_and_rows_match_jax(rng, n, d, qblock):
    x = rng.normal(size=(n, d)).astype(np.float32)
    q, s = ops.quantize_stacked(_t(x), qblock)
    qt, st = ttp.quantize_rows(_t(x), qblock)
    qj, sj = jtp.quantize_rows(jnp.asarray(x), qblock)  # eager
    qk, sk = jops.quantize_stacked(jnp.asarray(x), qblock=qblock)  # Pallas, interpret
    dp = d + (-d) % qblock
    assert q.shape == (n, dp) and s.shape == (n, dp // qblock)
    for codes in (qt, qj, qk):
        np.testing.assert_array_equal(q.numpy(), np.asarray(codes))
    np.testing.assert_array_equal(s.numpy(), np.asarray(sj))
    np.testing.assert_array_equal(st.numpy(), np.asarray(sj))
    assert _within_one_ulp(s.numpy(), sk)
    back = ttp.dequantize_rows(_t(qj), _t(sj), d, qblock)
    np.testing.assert_array_equal(back.numpy(), np.asarray(jtp.dequantize_rows(qj, sj, d, qblock)))
    np.testing.assert_array_equal(
        ops.dequantize_stacked(q, s, d).numpy(), qz.dequantize_stacked_plain(q, s, d).numpy()
    )


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_bf16_input_and_output_match_jax(rng, dtype):
    x = jnp.asarray(rng.normal(size=(6, 300)) * 2.0, jnp.bfloat16)
    xt = torch.from_numpy(np.asarray(x, np.float32)).to(torch.bfloat16)
    q, s, shp = ops.quantize_int8(xt, 128)
    qr, sr, _ = ref.quantize_ref(x, qblock=128)
    np.testing.assert_array_equal(q.numpy(), np.asarray(qr))
    np.testing.assert_array_equal(s.numpy(), np.asarray(sr))
    want = jops.dequantize_int8(qr, sr, (6, 300), getattr(jnp, dtype))
    got = ops.dequantize_int8(q, s, shp, getattr(torch, dtype))
    assert got.dtype == getattr(torch, dtype)
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(want, np.float32))


def test_quantize_zero_block_has_scale_zero():
    x = torch.zeros(2, 512)
    x[0, :128] = 3.0
    q, s = ops.quantize_stacked(x, 128)
    np.testing.assert_array_equal(s.numpy(), np.float32([[np.float32(3) / np.float32(127), 0, 0, 0], [0, 0, 0, 0]]))
    assert int(q[:, 128:].abs().max()) == 0 and int(q[0, :128].min()) == 127
    assert float(ops.dequantize_stacked(q, s, 512)[:, 128:].abs().max()) == 0.0


def test_quantize_rounds_half_to_even():
    x = torch.tensor([[0.5, 1.5, 2.5, -0.5, -2.5, 127.0, 63.5, -127.0]])
    q, s = ops.quantize_stacked(x, 8)
    assert float(s) == 1.0
    assert q.tolist() == [[0, 2, 2, 0, -2, 127, 64, -127]]


def test_quantize_wrappers_check_their_inputs():
    with pytest.raises(ValueError, match="qblock"):
        ops.quantize_stacked(torch.ones(2, 4), 0)
    with pytest.raises(ValueError, match=r"\(N, D\)"):
        ops.quantize_stacked(torch.ones(4), 2)
    with pytest.raises(ValueError, match="incompatible"):
        ops.dequantize_stacked(torch.zeros(2, 8, dtype=torch.int8), torch.zeros(2, 3), 8)
    with pytest.raises(ValueError, match="outside"):
        ops.dequantize_stacked(torch.zeros(2, 8, dtype=torch.int8), torch.zeros(2, 2), 9)
    with pytest.raises(ValueError, match=r"\(R, 1\)"):
        ops.dequantize_int8(torch.zeros(2, 8, dtype=torch.int8), torch.zeros(2), (16,))
    with pytest.raises(ValueError, match="do not hold blocks"):
        ttp.dequantize_rows(torch.zeros(2, 8, dtype=torch.int8), torch.zeros(2, 2), 8, 8)


# -- K6 -------------------------------------------------------------------------

SEGMENTS = {8: [0, 0, 0, 1, 1, 2, 2, 3], 12: [0, 0, 0, 0, 1, 1, 2, 2, 2, 2, 3, 3]}


@pytest.mark.parametrize("n", [8, 12])
@pytest.mark.parametrize("d,qblock,block_d", [(1024, 256, 512), (768, 128, 256), (512, 128, 512)])
def test_segment_dequant_mean_matches_jax(rng, n, d, qblock, block_d):
    x = jnp.asarray(rng.normal(size=(n, d)) * 0.1, jnp.float32)
    w = rng.uniform(0.5, 3.0, size=n).astype(np.float32)
    seg = np.asarray(SEGMENTS[n], np.int32)
    qk, sk = jops.quantize_stacked(x, qblock=qblock)
    want = jops.segment_dequant_mean(qk, sk, jnp.asarray(w), jnp.asarray(seg), 4, block_d=block_d)
    oracle = jax.jit(functools.partial(ref.segment_dequant_mean_ref, num_segments=4, block_d=block_d))(
        qk, sk, jnp.asarray(w), jnp.asarray(seg)
    )
    got = ops.segment_dequant_mean(_t(qk), _t(sk), _t(w), seg, 4)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-6)
    np.testing.assert_allclose(got.numpy(), np.asarray(oracle), rtol=0, atol=1e-6)


@pytest.mark.parametrize("dead", [(3, 5), (0, 3)])
def test_segment_dequant_mean_dead_segment_keeps_decoded_rows(rng, dead):
    n, d = 8, 512
    x = jnp.asarray(rng.normal(size=(n, d)), jnp.float32)
    w = rng.uniform(1.0, 2.0, size=n).astype(np.float32)
    w[dead[0]:dead[1]] = 0.0  # a whole segment of SEGMENTS[8]
    qk, sk = jops.quantize_stacked(x, qblock=128)
    got = ops.segment_dequant_mean(_t(qk), _t(sk), _t(w), SEGMENTS[8], 4)
    want = jops.segment_dequant_mean(qk, sk, jnp.asarray(w), jnp.asarray(SEGMENTS[8], jnp.int32), 4)
    decoded = ops.dequantize_stacked(_t(qk), _t(sk), d)
    rows = slice(*dead)
    np.testing.assert_array_equal(got[rows].numpy(), decoded[rows].numpy())
    np.testing.assert_array_equal(got[rows].numpy(), np.asarray(want)[rows])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-6)


def test_segment_dequant_mean_equals_decode_then_aggregate(rng):
    """Fusing changes the bytes moved, not the math: K6 == K5 then K2."""
    n, d, qblock = 8, 1024, 256
    x = torch.from_numpy(rng.normal(size=(n, d)).astype(np.float32) * 0.2)
    w = torch.from_numpy(rng.uniform(0.5, 2.0, size=n).astype(np.float32))
    q, s = ops.quantize_stacked(x, qblock)
    fused = ttp.fused_decode_segment_mean(q, s, w, SEGMENTS[n], 4)
    staged = ops.segment_mean(ops.dequantize_stacked(q, s, d), w, SEGMENTS[n], 4)
    np.testing.assert_allclose(fused.numpy(), staged.numpy(), rtol=0, atol=1e-6)


def test_segment_dequant_mean_validates_shapes():
    q = torch.zeros(4, 512, dtype=torch.int8)
    w = torch.ones(4)
    with pytest.raises(ValueError, match="incompatible"):
        ops.segment_dequant_mean(q, torch.zeros(4, 3), w, [0, 0, 1, 1], 2)
    with pytest.raises(ValueError, match="segment_ids"):
        ops.segment_dequant_mean(q, torch.zeros(4, 2), w, [0, 0, 1], 2)


# -- dispatch and counts ------------------------------------------------------------


def test_launch_counts_stay_zero_on_cpu():
    qz.reset_launch_counts()
    ha.reset_launch_counts()
    q, s = ops.quantize_stacked(torch.randn(4, 300), 128)
    ops.dequantize_stacked(q, s, 300)
    ops.segment_dequant_mean(q, s, torch.ones(4), [0, 0, 1, 1], 2)
    ops.dequantize_int8(*ops.quantize_int8(torch.randn(7, 3)))
    assert qz.LAUNCHES == {"quantize": 0, "dequantize": 0}
    assert ha.LAUNCHES["segment_dequant_mean"] == 0


def test_wrappers_refuse_devices_other_than_cpu_and_cuda():
    x = torch.empty(4, 8, device="meta")
    with pytest.raises(ValueError, match="CPU .* or CUDA"):
        ops.quantize_stacked(x, 4)
    with pytest.raises(ValueError, match="CPU .* or CUDA"):
        ops.dequantize_stacked(torch.empty(4, 8, dtype=torch.int8, device="meta"),
                               torch.empty(4, 2, device="meta"), 8)
    with pytest.raises(ValueError, match="CPU .* or CUDA"):
        ops.segment_dequant_mean(torch.empty(4, 8, dtype=torch.int8, device="meta"),
                                 torch.empty(4, 2, device="meta"), torch.empty(4, device="meta"), [0, 0, 1, 1], 2)
