"""K8 RG-LRU scan: the port's plain version against the JAX Pallas kernel
(interpret mode, as tests/test_kernels.py runs it) and its oracle
``rglru_scan_ref`` on the same numpy inputs; the model's log-step scan
against JAX's ``associative_scan``; the wrappers' checks; and, on a GPU,
the CUDA kernel against the plain version (this file runs on the card with
``-m cuda``, where JAX is not installed).

Tolerance against JAX: ``atol=1e-5``, the JAX kernel test's own (the
sequential loop, the chunked order and the associative scan pair the terms
differently). The chunked plain version (``chunk=CHUNK``, the CPU dispatch)
is held to the sequential loop within ``1e-6 * max(1, max|h|)`` and equals it
bit for bit when one chunk covers the sequence. On the card the kernel and
the chunked plain version round each multiply and each add alike, so they
agree bit for bit; a control with one chunk's carry zeroed must break the
bound against the sequential loop.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import ops as tops
from repro_torch.kernels import rglru_scan as rg
from repro_torch.models import recurrent as trec

try:  # the card's machine has no JAX; there only the tests marked cuda run (-m cuda)
    import jax
    import jax.numpy as jnp

    from repro.kernels import ops as jops
    from repro.kernels import ref as jref

    jops.set_interpret(True)
except ImportError:
    jax = jnp = jops = jref = None

JAX_CASES = [(33, 96), (128, 128), (64, 200)]  # tests/test_kernels.py
T = rg.CHUNK
CHUNK_LENGTHS = [1, T - 1, T, T + 1, 3 * T + 7]


def _bound(h):
    """How far the chunked order may sit from the sequential loop."""
    return 1e-6 * max(1.0, float(h.abs().max()))


def _zeroed_carry(a, b, h0, chunk):
    """The chunked plain version with the carry into chunk 1 zeroed (h0
    itself when there is one chunk): the control that must break ``_bound``.
    From a zero carry, chunks 1.. compose exactly as a fresh scan of the
    sequence from step ``chunk`` with h0 = 0."""
    if a.shape[1] <= chunk:
        return rg.rglru_scan_plain(a, b, torch.zeros_like(h0), chunk=chunk)[0]
    head = rg.rglru_scan_plain(a[:, :chunk], b[:, :chunk], h0, chunk=chunk)[0]
    tail = rg.rglru_scan_plain(a[:, chunk:], b[:, chunk:], torch.zeros_like(h0), chunk=chunk)[0]
    return torch.cat([head, tail], dim=1)


def _inputs(rng, s, d, B=2):
    a = rng.uniform(0.7, 0.999, size=(B, s, d)).astype(np.float32)
    b = (rng.normal(size=(B, s, d)) * 0.1).astype(np.float32)
    h0 = rng.normal(size=(B, d)).astype(np.float32)
    return a, b, h0


@pytest.mark.parametrize("s,d", JAX_CASES)
def test_plain_tracks_the_pallas_kernel_and_the_oracle(rng, s, d):
    a, b, h0 = _inputs(rng, s, d)
    pallas = jops.rglru_scan(jnp.asarray(a), jnp.asarray(b), jnp.asarray(h0))
    oracle = jref.rglru_scan_ref(jnp.asarray(a), jnp.asarray(b), jnp.asarray(h0))
    h, hT = tops.rglru_scan(torch.from_numpy(a), torch.from_numpy(b), torch.from_numpy(h0))  # CPU: plain
    assert h.dtype == hT.dtype == torch.float32 and h.shape == a.shape and hT.shape == h0.shape
    for want_h, want_hT in (pallas, oracle):
        np.testing.assert_allclose(h.numpy(), np.asarray(want_h), atol=1e-5)
        np.testing.assert_allclose(hT.numpy(), np.asarray(want_hT), atol=1e-5)


@pytest.mark.parametrize("s", [40] + CHUNK_LENGTHS)
def test_plain_takes_bf16_inputs_in_f32(rng, s):
    """bf16 a and b through the CPU dispatch (the chunked order), widened
    to f32 on use: the same bits as f32 inputs holding the same values."""
    a, b, h0 = _inputs(rng, s, 40)
    ja, jb = jnp.asarray(a, jnp.bfloat16), jnp.asarray(b, jnp.bfloat16)
    want_h, want_hT = jref.rglru_scan_ref(ja, jb, jnp.asarray(h0))
    ta = torch.from_numpy(np.array(ja.astype(jnp.float32))).bfloat16()
    tb = torch.from_numpy(np.array(jb.astype(jnp.float32))).bfloat16()
    h, hT = rg.rglru_scan(ta, tb, torch.from_numpy(h0))
    assert h.dtype == hT.dtype == torch.float32
    np.testing.assert_allclose(h.numpy(), np.asarray(want_h), atol=1e-5)
    np.testing.assert_allclose(hT.numpy(), np.asarray(want_hT), atol=1e-5)
    assert torch.equal(h, rg.rglru_scan_plain(ta.float(), tb.float(), torch.from_numpy(h0), chunk=T)[0])


@pytest.mark.parametrize("s", CHUNK_LENGTHS)
@pytest.mark.parametrize("d", [5, 200])
@pytest.mark.parametrize("chunk", ["T", "S", "S+1", "4S"])
def test_chunked_plain_tracks_the_oracle_and_the_loop(rng, s, d, chunk):
    """The chunked order at the chunk boundaries against JAX's oracle
    (``atol=1e-5``) and the sequential loop (``_bound``; bit for bit while
    one chunk covers the sequence, as chunks of S, S + 1 and 4S always do);
    hT is h[:, -1] bit for bit."""
    a, b, h0 = _inputs(rng, s, d)
    ta, tb, th0 = torch.from_numpy(a), torch.from_numpy(b), torch.from_numpy(h0)
    c = {"T": T, "S": s, "S+1": s + 1, "4S": 4 * s}[chunk]
    h, hT = rg.rglru_scan_plain(ta, tb, th0, chunk=c)
    assert torch.equal(hT, h[:, -1])
    want_h, want_hT = jref.rglru_scan_ref(jnp.asarray(a), jnp.asarray(b), jnp.asarray(h0))
    np.testing.assert_allclose(h.numpy(), np.asarray(want_h), atol=1e-5)
    np.testing.assert_allclose(hT.numpy(), np.asarray(want_hT), atol=1e-5)
    loop, loop_T = rg.rglru_scan_plain(ta, tb, th0)
    assert float((h - loop).abs().max()) <= _bound(loop)
    if s <= c:  # one chunk: the loop itself
        assert torch.equal(h, loop) and torch.equal(hT, loop_T)
    if chunk == "T":
        assert torch.equal(rg.rglru_scan(ta, tb, th0)[0], h)  # the CPU dispatch is the chunked order


@pytest.mark.parametrize("s,d", JAX_CASES)
@pytest.mark.parametrize("chunk", [16, 32])
def test_chunked_plain_tracks_the_pallas_kernel(rng, s, d, chunk):
    """Chunks shorter than the JAX cases, so that several compose, against
    the Pallas kernel in interpret mode."""
    a, b, h0 = _inputs(rng, s, d)
    want_h, want_hT = jops.rglru_scan(jnp.asarray(a), jnp.asarray(b), jnp.asarray(h0))
    h, hT = rg.rglru_scan_plain(torch.from_numpy(a), torch.from_numpy(b), torch.from_numpy(h0), chunk=chunk)
    np.testing.assert_allclose(h.numpy(), np.asarray(want_h), atol=1e-5)
    np.testing.assert_allclose(hT.numpy(), np.asarray(want_hT), atol=1e-5)
    assert torch.equal(hT, h[:, -1])


@pytest.mark.parametrize("s", CHUNK_LENGTHS)
def test_zeroed_carry_breaks_the_bound(rng, s):
    """The control: losing one chunk's carry must show against the loop."""
    a, b, h0 = (torch.from_numpy(x) for x in _inputs(rng, s, 200))
    loop = rg.rglru_scan_plain(a, b, h0)[0]
    assert float((_zeroed_carry(a, b, h0, T) - loop).abs().max()) > _bound(loop)
    assert float((rg.rglru_scan_plain(a, b, h0, chunk=T)[0] - loop).abs().max()) <= _bound(loop)


@pytest.mark.parametrize("s", [1, 2, 7, 16, 33])
def test_model_scan_tracks_jax_associative_scan(rng, s):
    """The layer code's scan (h_0 = 0) against the JAX model's
    ``associative_scan`` with the RG-LRU combine."""
    a, b, _ = _inputs(rng, s, 24)

    def combine(l, r):
        return l[0] * r[0], r[0] * l[1] + r[1]

    _, want = jax.lax.associative_scan(combine, (jnp.asarray(a), jnp.asarray(b)), axis=1)
    got = trec._associative_scan(torch.from_numpy(a), torch.from_numpy(b))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)


def test_wrappers_check_their_inputs():
    a = torch.zeros(2, 5, 8)
    with pytest.raises(ValueError, match=r"h0 \(B,D\)"):
        rg.rglru_scan(a, a, torch.zeros(2, 5))
    with pytest.raises(ValueError, match="share a dtype"):
        rg.rglru_scan(a, a.double(), torch.zeros(2, 8))
    with pytest.raises(ValueError, match="empty"):
        rg.rglru_scan(a[:, :0], a[:, :0], torch.zeros(2, 8))
    meta = torch.empty(2, 5, 8, device="meta")
    with pytest.raises(ValueError, match="CPU .* or CUDA"):
        rg.rglru_scan(meta, meta, torch.empty(2, 8, device="meta"))
    assert rg.LAUNCHES == {"rglru_scan": 0}  # the CPU never launches the kernel


# -- on the card: K8 against its plain version -----------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("B,s,d", [(2, 33, 96), (2, 128, 128), (2, 64, 200), (1, 1000, 4096), (3, 17, 5),
                                   (2, T - 1, 200), (2, T, 5), (2, T + 1, 200), (2, 3 * T + 7, 5),
                                   (2, 3 * T + 7, 200)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_is_bit_equal_to_plain_on_gpu(cuda, B, s, d, dtype):
    """Bit-equal to the chunked plain version and across launches, within
    ``_bound`` of the sequential loop; the zeroed-carry control is not."""
    gen = torch.Generator(device=cuda).manual_seed(0)
    a = (torch.rand(B, s, d, generator=gen, device=cuda) * 0.3 + 0.7).to(dtype)
    b = (torch.randn(B, s, d, generator=gen, device=cuda) * 0.1).to(dtype)
    h0 = torch.randn(B, d, generator=gen, device=cuda)
    before = rg.LAUNCHES["rglru_scan"]
    h, hT = rg.rglru_scan(a, b, h0)
    h2, hT2 = rg.rglru_scan(a, b, h0)
    hp, hTp = rg.rglru_scan_plain(a, b, h0, chunk=rg.CHUNK)
    loop = rg.rglru_scan_plain(a, b, h0)[0]
    torch.cuda.synchronize()
    assert rg.LAUNCHES["rglru_scan"] == before + 2
    assert torch.equal(h, hp) and torch.equal(hT, hTp)
    assert torch.equal(h, h2) and torch.equal(hT, hT2) and torch.equal(hT, h[:, -1])
    assert float((h - loop).abs().max()) <= _bound(loop)
    assert float((_zeroed_carry(a, b, h0, rg.CHUNK) - loop).abs().max()) > _bound(loop)
