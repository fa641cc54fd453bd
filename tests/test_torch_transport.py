"""The compressed transport against the JAX package: codecs and
``TransportSpec``, the codec branch of the level sync (anchor, error-feedback
residual, dead groups, masked clients, ``delta_cloud``), the bits accounting
in ``dist.collectives`` / ``core.cost_model`` / the runner, the
``optim.compression`` operators, and the ``int8_cloud`` / ``int8_ef_both``
scenarios end to end on the CPU.

Both packages get the same numpy inputs; the port runs the plain versions of
K4-K6 on CPU tensors. Tolerances: step functions ``atol=1e-6`` (f32 sums in
another order, and XLA's ``jit`` computes the block scale ``absmax / 127`` as
a multiply by the reciprocal, one ulp off the IEEE division the port does);
whole scenarios per-round loss ``rtol=1e-4``, accuracy within 0.01 and final
parameters ``atol=1e-4``, as the uncompressed scenarios in
``test_torch_runner.py``; both hold for the transport runs without
loosening.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import optim as joptim
from repro.core import aggregation as jagg
from repro.core import cost_model as jcm
from repro.core import hierfavg as jh
from repro.core.hierarchy import parse_fanouts as jparse
from repro.dist import collectives as jcoll
from repro.fed import scenarios as jscen
from repro.fed import transport as jtp
from repro.optim import compression as jcomp
from repro_torch import optim as toptim
from repro_torch.core import aggregation as tagg
from repro_torch.core import cost_model as tcm
from repro_torch.core import hierfavg as th
from repro_torch.core.hierarchy import parse_fanouts as tparse
from repro_torch.dist import collectives as tcoll
from repro_torch.fed import scenarios as tscen
from repro_torch.fed import transport as ttp
from repro_torch.optim import compression as tcomp
from repro_torch.testing.parity import assert_close, to_numpy

STEP_TOL = dict(rtol=0.0, atol=1e-6)


def _t(x):
    return torch.from_numpy(np.array(x))


def _jloss(params, batch, _rng):
    return 0.5 * jnp.sum((params["w"] - batch["c"]) ** 2)


def _tloss(params, batch, _rng):
    return 0.5 * torch.sum((params["w"] - batch["c"]) ** 2)


class Pair:
    """One quadratic problem (client i pulls toward center c_i) run through
    ``build_hier_round`` of both packages from the same zero init."""

    def __init__(self, tree, kappas, transport, *, seed=0, dim=4, **cfg):
        rng = np.random.default_rng(seed)
        self.jspec, self.tspec = jparse(tree), tparse(tree)
        n = self.tspec.num_clients
        self.centers = rng.normal(size=(n, dim)).astype(np.float32)
        self.sizes = rng.integers(1, 5, size=n).astype(np.float32)
        jt = None if transport is None else jtp.TransportSpec.parse(transport)
        tt = None if transport is None else ttp.TransportSpec.parse(transport)
        self.jcfg = jh.HierFAVGConfig.multi_level(kappas, transport=jt, **cfg)
        self.tcfg = th.HierFAVGConfig.multi_level(kappas, transport=tt, **cfg)
        self.jopt, self.topt = joptim.sgd(0.1), toptim.sgd(0.1)
        self.js = jh.init_state(jax.random.PRNGKey(0), {"w": jnp.zeros(dim)}, self.jopt, self.jspec, self.jcfg)
        self.ts = th.init_state(torch.Generator().manual_seed(0), {"w": torch.zeros(dim)}, self.topt,
                                self.tspec, self.tcfg)
        self.jround = jax.jit(jh.build_hier_round(_jloss, self.jopt, self.jspec, self.jcfg, jnp.asarray(self.sizes)))
        self.tround = th.build_hier_round(_tloss, self.topt, self.tspec, self.tcfg, _t(self.sizes))
        k1 = self.tcfg.kappa1
        self.jbatch = {"c": jnp.asarray(np.stack([self.centers] * k1))}
        self.tbatch = {"c": _t(np.stack([self.centers] * k1))}
        self.r = 0

    def step(self, mask=None, jax_too=True):
        if jax_too:
            jm = None if mask is None else jnp.asarray(mask, jnp.float32)
            self.js, _ = self.jround(self.js, self.jbatch, jnp.int32(self.r), jm)
        tm = None if mask is None else _t(np.asarray(mask, np.float32))
        self.ts, _ = self.tround(self.ts, self.tbatch, self.r, tm)
        self.r += 1

    def check(self, what):
        assert_close(to_numpy(self.ts.params), jax.device_get(self.js.params), what=f"{what} params", **STEP_TOL)
        for field in ("anchor", "residual"):
            j, t = getattr(self.js, field), getattr(self.ts, field)
            assert (j is None) == (t is None), field
            if t is not None:
                assert_close(to_numpy(t), jax.device_get(j), what=f"{what} {field}", **STEP_TOL)


def _clone(state):
    c = lambda tree: None if tree is None else {k: v.clone() for k, v in tree.items()}
    return state._replace(params=c(state.params), anchor=c(state.anchor), residual=c(state.residual))


# ---------------------------------------------------------------------------
# Codec and spec units
# ---------------------------------------------------------------------------


def test_quantize_rows_roundtrip_bound(rng):
    x = torch.from_numpy(rng.normal(size=(4, 700)).astype(np.float32) * 2.0)
    q, s = ttp.quantize_rows(x, 256)
    assert q.shape == (4, 768) and s.shape == (4, 3)
    back = ttp.dequantize_rows(q, s, 700, 256)
    assert back.shape == (4, 700)
    assert float((back - x).abs().max()) <= float(s.max()) * 0.5 + 1e-6


def test_quantize_rows_blocks_stay_per_client(rng):
    x = rng.normal(size=(3, 512)).astype(np.float32)
    q1, s1 = ttp.quantize_rows(_t(x), 256)
    x[1] *= 100.0
    q2, s2 = ttp.quantize_rows(_t(x), 256)
    assert torch.equal(q1[[0, 2]], q2[[0, 2]]) and torch.equal(s1[[0, 2]], s2[[0, 2]])


@pytest.mark.parametrize("text", ["identity", "int8", "int8:128", "int8_ef", "int8_ef:64", "fp32"])
def test_codec_matches_jax(text):
    j, t = jtp.parse_codec(text), ttp.parse_codec(text)
    assert (t.name, t.is_identity, t.error_feedback, t.bits_per_param) == (
        j.name, j.is_identity, j.error_feedback, j.bits_per_param)
    assert ttp.Int8BlockCodec(block=256).bits_per_param == pytest.approx(8.125)
    assert ttp.int8_ef(256).error_feedback and not ttp.Int8BlockCodec().error_feedback


@pytest.mark.parametrize("text", ["identity/int8:128/int8_ef", "int8_ef:128/int8_ef:128", "identity/int8:256",
                                  "fp32/identity"])
def test_transport_spec_parse_and_describe_match_jax(text):
    j, t = jtp.TransportSpec.parse(text), ttp.TransportSpec.parse(text)
    assert t.describe() == j.describe()
    assert (t.depth, t.is_trivial, t.needs_residual, t.bits_vector()) == (
        j.depth, j.is_trivial, j.needs_residual, j.bits_vector())
    assert [t.bits_per_param(l) for l in range(1, t.depth + 1)] == [j.bits_per_param(l) for l in range(1, j.depth + 1)]
    assert ttp.transport_wire_bytes_per_param(t, t.depth) == jtp.transport_wire_bytes_per_param(j, j.depth)


def test_transport_spec_constructors_and_errors():
    spec = ttp.TransportSpec.parse("identity/int8:128/int8_ef")
    assert spec.codec(1).is_identity and spec.codec(2).block == 128 and spec.codec(3).error_feedback
    assert spec.describe() == "identity/int8:128/int8_ef:256"
    assert ttp.TransportSpec.identity(2).is_trivial
    assert [c.is_identity for c in ttp.TransportSpec.cloud_int8(3).codecs] == [True, True, False]
    assert ttp.TransportSpec.uniform(ttp.int8_ef(64), 2).describe() == "int8_ef:64/int8_ef:64"
    for bad in ("int4", "int8:0"):
        with pytest.raises(ValueError):
            ttp.parse_codec(bad)
    with pytest.raises(ValueError):
        ttp.TransportSpec.parse("")
    with pytest.raises(ValueError):
        spec.codec(4)
    assert ttp.transport_wire_bytes_per_param(None, 2) == jtp.transport_wire_bytes_per_param(None, 2) == (4.0, 4.0)


def test_error_feedback_residual_matches_jax(rng):
    """EF codec: new residual == pre-encode input minus what the wire
    delivered; the carried residual joins the next upload."""
    d = rng.normal(size=(3, 200)).astype(np.float32)
    jc, tc = jtp.int8_ef(128), ttp.int8_ef(128)
    jout1, jr1 = jc.roundtrip({"w": jnp.asarray(d)}, {"w": jnp.zeros((3, 200))})
    out1, r1 = tc.roundtrip({"w": _t(d)}, {"w": torch.zeros(3, 200)})
    assert torch.equal(r1["w"], _t(d) - out1["w"])
    out2, r2 = tc.roundtrip({"w": _t(d)}, r1)
    jout2, jr2 = jc.roundtrip({"w": jnp.asarray(d)}, jr1)
    np.testing.assert_allclose((out2["w"] + r2["w"]).numpy(), (_t(d) + r1["w"]).numpy(), atol=1e-6)
    for got, want in ((out1, jout1), (r1, jr1), (out2, jout2), (r2, jr2)):
        assert_close(to_numpy(got), jax.device_get(want), what="EF round trip", **STEP_TOL)
    # EF telescopes: two decoded uploads track 2 * delta within one quantum
    np.testing.assert_allclose((out1["w"] + out2["w"]).numpy(), 2 * d, atol=float(np.abs(d).max()) / 127 + 1e-5)


def test_plain_codec_leaves_residual_untouched(rng):
    codec = ttp.Int8BlockCodec(block=128)
    delta = {"w": torch.from_numpy(rng.normal(size=(2, 128)).astype(np.float32))}
    _, res = codec.roundtrip(delta, None)
    assert res is None
    marker = {"w": torch.full((2, 128), 7.0)}
    assert codec.roundtrip(delta, marker)[1] is marker
    with pytest.raises(ValueError, match="residual"):
        ttp.int8_ef().roundtrip(delta, None)


# ---------------------------------------------------------------------------
# The level sync with a transport
# ---------------------------------------------------------------------------


def test_identity_transport_is_bitwise_the_uncompressed_path():
    plain = Pair("3,3/2", (2, 2), None)
    ident = Pair("3,3/2", (2, 2), "identity/identity")
    for _ in range(5):
        plain.step(jax_too=False)
        ident.step(jax_too=False)
    assert ident.ts.anchor is None and ident.ts.residual is None
    assert torch.equal(plain.ts.params["w"], ident.ts.params["w"])


@pytest.mark.parametrize("transport,atol", [("identity/int8", 5e-3), ("int8_ef:128/int8_ef:128", 2e-2),
                                            ("int8:128/identity", 5e-3)])
def test_transport_round_tracks_jax_and_the_uncompressed_run(transport, atol):
    plain = Pair("3,3/2", (2, 2), None, seed=7)
    pair = Pair("3,3/2", (2, 2), transport, seed=7)
    for r in range(6):
        plain.step(jax_too=False)
        pair.step()
        pair.check(f"{transport} round {r}")
    got, ref = pair.ts.params["w"].numpy(), plain.ts.params["w"].numpy()
    assert not np.array_equal(got, ref)  # the codec ran
    np.testing.assert_allclose(got, ref, atol=atol)


def test_three_level_ragged_tree_with_a_transport_matches_jax():
    pair = Pair("3,2,3/2,1/2", (2, 2, 2), "identity/int8/int8_ef", dim=3)
    for r in range(8):  # spans the level-2 and level-3 boundaries
        pair.step()
        pair.check(f"round {r}")
    got = pair.ts.params["w"].numpy()
    assert np.isfinite(got).all()
    target = np.average(pair.centers, axis=0, weights=pair.sizes)
    assert np.abs(got - target[None]).max() < 0.5


@pytest.mark.parametrize("masked", [False, True], ids=["all_alive", "masked"])
def test_delta_cloud_matches_jax(masked):
    pair = Pair("3,3,4/3", (1, 2), None, seed=3, delta_cloud=True)
    rng = np.random.default_rng(5)
    for r in range(6):
        mask = (rng.random(10) > 0.3).astype(np.float32) if masked else None
        pair.step(mask)
        pair.check(f"round {r}")
    assert pair.ts.residual is None and pair.ts.anchor is not None


def test_dead_group_keeps_exact_params_under_codec():
    """A client whose whole edge died sent nothing and received nothing: its
    params and anchor stay exact, with no quantization noise; a masked
    client in a live edge keeps its EF residual."""
    pair = Pair("3,3/2", (1, 2), "int8_ef:128/int8_ef:128")
    for _ in range(2):  # all alive: params, anchor and residual move
        pair.step()
    before = _clone(pair.ts)
    expect, _ = th.build_local_step(_tloss, pair.topt)(_clone(pair.ts), {"c": _t(pair.centers)})
    mask = np.array([0, 0, 0, 1, 0, 1], np.float32)  # edge 0 dead, client 4 masked
    pair.step(mask)
    pair.check("masked edge sync")
    p = pair.ts.params["w"]
    assert torch.equal(p[:3], expect.params["w"][:3])
    assert torch.equal(pair.ts.anchor["w"][:3], before.anchor["w"][:3])
    for i in (0, 1, 2, 4):
        assert torch.equal(pair.ts.residual["w"][i], before.residual["w"][i])
    assert torch.equal(p[3], p[5]) and not torch.equal(p[3], expect.params["w"][3])


def test_anchor_is_a_copy_not_an_alias_of_the_params():
    pair = Pair("3,3/2", (1, 2), "identity/int8")
    pair.step(jax_too=False)  # an (identity) edge sync: the anchor re-syncs
    s = pair.ts
    assert s.anchor["w"].untyped_storage().data_ptr() != s.params["w"].untyped_storage().data_ptr()
    assert torch.equal(s.anchor["w"], s.params["w"])
    anchor = s.anchor["w"].clone()
    after, _ = th.build_local_step(_tloss, pair.topt)(s, {"c": _t(pair.centers)})  # updates params in place
    assert torch.equal(after.anchor["w"], anchor)
    assert not torch.equal(after.params["w"], anchor)  # so the next delta is not zero


def test_transport_state_allocation():
    topo = th.FedTopology(num_edges=2, clients_per_edge=3)
    opt = toptim.sgd(0.1)
    for text, anchor, residual in (("identity/identity", False, False), ("identity/int8", True, False),
                                   ("identity/int8_ef", True, True)):
        cfg = th.HierFAVGConfig(kappa1=2, kappa2=2, transport=ttp.TransportSpec.parse(text))
        s = th.init_state(torch.Generator(), {"w": torch.zeros(4)}, opt, topo, cfg)
        assert (s.anchor is not None, s.residual is not None) == (anchor, residual), text
        if residual:
            assert s.residual["w"].dtype == torch.float32 and not s.residual["w"].any()
    cfg = th.HierFAVGConfig(kappa1=2, kappa2=2, delta_cloud=True)
    assert th.init_state(torch.Generator(), {"w": torch.zeros(4)}, opt, topo, cfg).anchor is not None


def test_config_validation_matches_jax():
    for mod, tp in ((jh, jtp), (th, ttp)):
        with pytest.raises(ValueError, match="levels"):
            mod.HierFAVGConfig(kappa1=2, kappa2=2, transport=tp.TransportSpec.parse("int8"))
        with pytest.raises(ValueError, match="subsumes delta_cloud"):
            mod.HierFAVGConfig(kappa1=2, kappa2=2, delta_cloud=True, transport=tp.TransportSpec.parse("identity/int8"))
        with pytest.raises(TypeError):
            mod.HierFAVGConfig(kappa1=2, kappa2=2, transport="identity/int8")
        cfg = mod.HierFAVGConfig(kappa1=2, kappa2=2, delta_cloud=True, transport=tp.TransportSpec.identity(2))
        assert not cfg.transport_active
        assert mod.HierFAVGConfig(kappa1=2, kappa2=2, transport=tp.TransportSpec.parse("int8/int8")).transport_active
    with pytest.raises(ValueError, match="sync_opt_state"):
        th.build_level_sync(th.FedTopology(2, 2), th.HierFAVGConfig(2, 2, delta_cloud=True, sync_opt_state=True),
                            torch.ones(4), 2)


# ---------------------------------------------------------------------------
# Bits accounting
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("tree,kappas,bits", [
    ("10,10,10,10,10/5", (6, 10), None),
    ("10,10,10,10,10/5", (6, 10), (32.0, 8.125)),
    ("16,12,10,7,5/5", (6, 10), (16.0, 8.0)),
    ("4,3,2,5/2,2/2", (2, 3, 4), (32.0, 16.0, 8.0)),
])
def test_hierarchy_traffic_matches_jax(tree, kappas, bits):
    got = tcoll.hierarchy_traffic_per_step(1e6, tparse(tree), kappas, bits_per_param=bits)
    want = jcoll.hierarchy_traffic_per_step(1e6, jparse(tree), kappas, bits_per_param=bits)
    assert got == want
    if bits is not None:
        base = tcoll.hierarchy_traffic_per_step(1e6, tparse(tree), kappas)
        np.testing.assert_allclose(got, [b * x / 32.0 for b, x in zip(base, bits)])


@pytest.mark.parametrize("bits", [(8.0,), (32.0, 0.0)])
def test_hierarchy_traffic_refuses_bad_bits(bits):
    with pytest.raises(ValueError):
        tcoll.hierarchy_traffic_per_step(1e6, tparse("2,2/2"), (2, 2), bits_per_param=bits)


@pytest.mark.parametrize("edge,cloud", [(32.0, 8.0), (8.0, 8.0), (8.25, 8.125), (32.0, 32.0)])
def test_workload_costs_with_bits_match_jax(edge, cloud):
    got = tcm.paper_workload("mnist").with_bits(edge, cloud)
    want = jcm.paper_workload("mnist").with_bits(edge, cloud)
    for f in ("t_comp", "t_comm_edge", "e_comp", "e_comm_edge", "cloud_latency_mult", "t_comm_cloud"):
        assert getattr(got, f) == getattr(want, f), f
    assert tcm.cloud_interval_time(got, 6, 10) == jcm.cloud_interval_time(want, 6, 10)
    assert tcm.cloud_interval_energy(got, 6, 10) == jcm.cloud_interval_energy(want, 6, 10)
    with pytest.raises(ValueError):
        tcm.paper_workload("mnist").with_bits(0.0, 8.0)


def test_fused_decode_segment_mean_matches_jax_composition(rng):
    n, d = 8, 512
    x = (rng.normal(size=(n, d)) * 0.1).astype(np.float32)
    w = rng.uniform(0.5, 2.0, size=n).astype(np.float32)
    seg = [0, 0, 0, 1, 1, 2, 2, 2]
    q, s = ttp.quantize_rows(_t(x), 128)
    fused = ttp.fused_decode_segment_mean(q, s, _t(w), seg, 3)
    jq, js = jtp.quantize_rows(jnp.asarray(x), 128)
    composed = jagg.segment_weighted_mean(jtp.dequantize_rows(jq, js, d, 128), jnp.asarray(w),
                                          jnp.asarray(seg, jnp.int32), 3)
    np.testing.assert_allclose(fused.numpy(), np.asarray(composed), rtol=0, atol=1e-6)


def test_delta_weighted_mean_matches_jax(rng):
    x = rng.normal(size=(6, 5)).astype(np.float32)
    a = rng.normal(size=(6, 5)).astype(np.float32)
    w = rng.uniform(1, 3, 6).astype(np.float32)
    m = np.array([1, 0, 1, 1, 0, 1], np.float32)
    got = tagg.delta_weighted_mean({"x": _t(x)}, {"x": _t(a)}, _t(w), _t(m))
    want = jagg.delta_weighted_mean({"x": jnp.asarray(x)}, {"x": jnp.asarray(a)}, jnp.asarray(w), jnp.asarray(m))
    assert_close(to_numpy(got), jax.device_get(want), what="delta_weighted_mean", rtol=0, atol=1e-6)


# ---------------------------------------------------------------------------
# optim.compression
# ---------------------------------------------------------------------------


def _tree(rng, scale=2.0):
    return {
        "w1": (rng.normal(size=(37, 129)) * scale).astype(np.float32),
        "b": (rng.normal(size=(513,)) * scale).astype(np.float32),
        "nested": {"w2": (rng.normal(size=(8, 64)) * scale).astype(np.float32)},
    }


def _torch_tree(tree):
    return {k: _torch_tree(v) if isinstance(v, dict) else _t(v) for k, v in tree.items()}


@pytest.mark.parametrize("block", [64, 128, 256])
def test_compression_matches_jax_and_bounds_the_error(rng, block):
    tree = _tree(rng)
    jq = jcomp.quantize_int8(jax.tree_util.tree_map(jnp.asarray, tree), block=block)
    tq = tcomp.quantize_int8(_torch_tree(tree), block=block)
    assert_close(to_numpy(tq.payload), jax.device_get(jq.payload), what="payload", rtol=0, atol=0)
    assert_close(to_numpy(tq.scales), jax.device_get(jq.scales), what="scales", rtol=0, atol=0)
    assert tq.shapes == jq.shapes and tcomp.compressed_bytes(tq) == jcomp.compressed_bytes(jq)
    back = tcomp.dequantize_int8(tq)
    assert_close(to_numpy(back), jax.device_get(jcomp.dequantize_int8(jq)), what="decoded", rtol=0, atol=0)
    for x, b, s in zip(tcomp._leaves(_torch_tree(tree)), tcomp._leaves(back), tcomp._leaves(tq.scales)):
        bound = s.repeat_interleave(block)[: x.numel()].reshape(x.shape)
        assert bool(((b - x).abs() <= bound * 0.5 + 1e-7).all())


def test_compression_is_self_describing_and_takes_like(rng):
    tree = _torch_tree(_tree(rng))
    q = tcomp.quantize_int8(tree, block=128)
    via_meta, via_like = tcomp.dequantize_int8(q), tcomp.dequantize_int8(q, tree)
    for a, b, x in zip(tcomp._leaves(via_meta), tcomp._leaves(via_like), tcomp._leaves(tree)):
        assert torch.equal(a, b) and a.shape == x.shape and a.dtype == x.dtype
    legacy = tcomp.QuantizedTree(payload=q.payload, scales=q.scales, block=q.block)
    with pytest.raises(ValueError, match="like"):
        tcomp.dequantize_int8(legacy)
    assert tcomp.dequantize_int8(legacy, tree)["nested"]["w2"].shape == (8, 64)
    bf = tcomp.quantize_int8({"w": torch.randn(16, 128).to(torch.bfloat16)}, block=128)
    assert tcomp.dequantize_int8(bf)["w"].dtype == torch.bfloat16


def test_compression_zero_blocks_and_wire_size(rng):
    back = tcomp.dequantize_int8(tcomp.quantize_int8({"w": torch.zeros(4, 300)}, block=128))
    assert float(back["w"].abs().max()) == 0.0
    x = torch.zeros(512)
    x[:128] = 3.0
    back2 = tcomp.dequantize_int8(tcomp.quantize_int8({"w": x}, block=128))["w"]
    assert float(back2[128:].abs().max()) == 0.0
    np.testing.assert_allclose(back2[:128].numpy(), 3.0, rtol=1e-6)
    tree = _torch_tree(_tree(rng))
    n_params = sum(x.numel() for x in tcomp._leaves(tree))
    wire = tcomp.compressed_bytes(tcomp.quantize_int8(tree, block=256))
    assert n_params <= wire < 4 * n_params * 0.3


def test_compression_payload_equals_the_transport_rows(rng):
    """On block-aligned shapes the flat codec, the stacked transport codec
    and the JAX jnp quantizer produce one wire format."""
    x = (rng.normal(size=(8, 1024)) * 3.0).astype(np.float32)
    q = tcomp.quantize_int8({"x": _t(x)}, block=256)
    qr, sr = ttp.quantize_rows(_t(x), 256)
    assert torch.equal(q.payload["x"].reshape(-1), qr.reshape(-1))
    assert torch.equal(q.scales["x"], sr.reshape(-1))
    jq = jcomp.quantize_int8({"x": jnp.asarray(x)}, block=256)
    np.testing.assert_array_equal(q.payload["x"].numpy(), np.asarray(jq.payload["x"]))


@pytest.mark.parametrize("frac", [0.1, 0.5])
def test_topk_sparsify_matches_jax(rng, frac):
    tree = _tree(rng)
    js, jm = jcomp.topk_sparsify(jax.tree_util.tree_map(jnp.asarray, tree), frac)
    ts, tm = tcomp.topk_sparsify(_torch_tree(tree), frac)
    assert_close(to_numpy(ts), jax.device_get(js), what="topk values", rtol=0, atol=0)
    assert_close(to_numpy(tm), jax.device_get(jm), what="topk mask", rtol=0, atol=0)


def test_randk_sparsify_is_unbiased_and_keeps_about_frac():
    """JAX's random bits cannot be matched, so the port is held to the
    operator's statistics: E[sparse] = x and P(keep) = frac."""
    x = torch.full((200_000,), 2.0)
    sparse, mask = tcomp.randk_sparsify({"x": x}, 0.25, torch.Generator().manual_seed(0))
    kept = float(mask["x"].mean())
    assert abs(kept - 0.25) < 4 * (0.25 * 0.75 / 2e5) ** 0.5
    assert abs(float(sparse["x"].mean()) - 2.0) < 0.02
    assert set(torch.unique(sparse["x"]).tolist()) == {0.0, 8.0}
    again = tcomp.randk_sparsify({"x": x}, 0.25, torch.Generator().manual_seed(0))[1]["x"]
    assert torch.equal(again, mask["x"])  # seeded


# ---------------------------------------------------------------------------
# The scenarios end to end
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name,overrides", [
    ("int8_cloud", ["run.num_rounds=20", "run.eval_every=10"]),  # superround engine, 2 cloud syncs
    ("int8_ef_both", ["run.num_rounds=8"]),  # per-round path (eval every round)
    ("quickstart", ["run.num_rounds=8", "schedule.delta_cloud=true"]),  # cloud sync in delta form
])
def test_transport_scenario_tracks_jax(name, overrides):
    jspec, tspec = jscen.get(name, overrides=overrides), tscen.get(name, overrides=overrides)
    np_params = jax.device_get(jspec.init_params(jax.random.PRNGKey(jspec.run.seed + 1)))
    jr, js = jspec.run_experiment()
    tr, ts = tspec.run_experiment(device="cpu", params=tspec.params_from_numpy(np_params, "cpu"))
    jt, tt = jr.hier_config.transport, tr.hier_config.transport
    assert (tt is None and jt is None) or tt.describe() == jt.describe()
    assert len(tr.history) == len(jr.history) == tspec.run.num_rounds
    for a, b in zip(jr.history, tr.history):
        assert (b.round, b.step) == (a.round, a.step)
        assert b.loss == pytest.approx(a.loss, rel=1e-4), f"round {a.round} loss"
        assert (a.accuracy is None) == (b.accuracy is None)
        if a.accuracy is not None:
            assert abs(b.accuracy - a.accuracy) <= 0.01, f"round {a.round} accuracy"
        assert b.wire_mb == pytest.approx(a.wire_mb, rel=1e-12)
        assert b.sim_time_s == pytest.approx(a.sim_time_s, rel=1e-12)
        assert b.sim_energy_j == pytest.approx(a.sim_energy_j, rel=1e-12)
    assert_close(to_numpy(ts.params), jax.device_get(js.params), rtol=0.0, atol=1e-4, what=f"{name} params")
    assert_close(to_numpy(ts.anchor), jax.device_get(js.anchor), rtol=0.0, atol=1e-4, what=f"{name} anchor")
    assert (ts.residual is None) == (js.residual is None)


def test_compressed_wire_is_accounted_below_the_fp32_one():
    runs = {}
    for name in ("hierfavg_edge_iid", "int8_cloud", "int8_ef_both"):
        spec = tscen.get(name, overrides=["run.num_rounds=10", "run.eval_every=10", "data.num_samples=600"])
        runner, _ = spec.run_experiment(device="cpu")
        runs[name] = runner.history[-1]
    fp32, cloud, both = runs["hierfavg_edge_iid"], runs["int8_cloud"], runs["int8_ef_both"]
    assert fp32.wire_mb > cloud.wire_mb > both.wire_mb > 0
    assert fp32.sim_time_s > cloud.sim_time_s > both.sim_time_s
