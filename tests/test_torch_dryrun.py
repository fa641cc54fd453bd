"""The dry run and its op counter in the port against the JAX package, on
the CPU (ROADMAP.md Queue 1 item 15): ``analysis/opcount.py`` (the
counterpart of ``repro.analysis.hlo``), ``launch/dryrun.py``,
``experiments/roofline_report.py``, and the train cell whose edges span
ranks (F3) or whose client count the client axes do not divide (F4).

- FLOPs: a smoke LM's loss and gradient over stacked clients (naive
  attention: the smoke configs' ``attn_chunk=0``, in both packages) and
  the MLP classifier's local step, counted from the ops the port
  dispatches, within 1 % of ``hlo.analyze`` on JAX's compiled HLO (the
  gap is printed).
- HBM bytes: each rule (operands read once and the result written once; a
  gather reads its region; an in-place update writes its region; views
  and allocation free) against bytes counted by hand, and the port's
  total against JAX's printed (eager PyTorch keeps broadcasts and
  transposes as views, where XLA's CPU program materialises some, so the
  two are not ordered; PERF.md states the gap).
- The ring model and the axis classes: ``CollectiveRecord`` and
  ``classify_groups`` against JAX's on the same records and groups.
- Collective counts on fake (1, 2) and (2, 2) worlds (``torch.testing``'s
  "fake" process group, in this process, destroyed after each test, the
  hint mesh cleared): ROADMAP item 16's formula for a smoke dense LM, 2L
  model sums and 2 gathers a prefill, 4L + 2 sums, 1 max, 1 gather and the
  grad norm's sum a loss and gradient, equal to ``dist.sharding.COUNTS``.
- F3: the train cell on 4 gloo ranks, mesh (4, 1), smoke yi-9b's 2 edges
  of 2 clients, one client a rank and each edge over 2 ranks, tracks JAX's
  single-device ``build_train_step`` after every call of a cloud interval;
  its edge syncs all-reduce over "data" in groups of 2, its cloud sync in
  one group of 4. F4: a client count the client axes do not divide is
  refused with JAX's words.
- The kernels' fake branch: K1, K2, K7 and K8 on meta tensors under the
  dry run's counter (on the meta device) charge it and return an empty
  output, launching nothing; meta tensors outside it are refused, as
  before; on CPU tensors they take their plain versions and charge
  nothing.
- End to end: ``dryrun.main`` on a fake world writes artifacts with JAX's
  keys (and a refused record), and ``roofline_report`` prints their rows.

The dry run and the report touch no device (their tensors are meta), so
they are not among the entry points that must raise without a GPU
(``tests/test_torch_port_hygiene.py``).
"""
import contextlib
import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import optim as joptim
from repro.analysis import hlo
from repro.configs import registry as jreg
from repro.core import hierfavg as jh
from repro.dist import sharding as jsh
from repro.fed import api as japi
from repro.models import transformer as jt
from repro_torch import optim as toptim
from repro_torch.analysis import opcount
from repro_torch.configs import registry as treg
from repro_torch.configs.base import ShapeSpec
from repro_torch.core import hierfavg as th
from repro_torch.dist import launch, sharding
from repro_torch.experiments import roofline_report
from repro_torch.fed import api as tapi
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import hier_aggregate as ha
from repro_torch.kernels import rglru_scan as rg
from repro_torch.launch import dryrun, steps
from repro_torch.launch import mesh as tmesh
from repro_torch.models import params_from_numpy
from repro_torch.models import transformer as tt
from repro_torch.tree import tree_map

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_mp_ranks as ranks  # noqa: E402

FLOP_RTOL = 0.01
STATE_TOL = dict(rtol=3e-6, atol=2e-7)  # test_torch_launch_cells.py's mesh tolerance
METRIC_TOL = dict(rtol=1e-5, atol=1e-7)
SPAN_ARCH, SPAN_SHAPE, LR = "yi-9b", ("train_cut", 8, 4, "train"), 0.05


class _FakeMesh:
    def __init__(self, **shape):
        self.axis_names = tuple(shape)
        self.shape = dict(shape)


@contextlib.contextmanager
def fake_world(n):
    """A fake world of ``n`` ranks in this process; gone afterwards, with
    the hint mesh, even when the test fails."""
    try:
        with dryrun.fake_world(n):
            yield
    finally:
        sharding.set_hint_mesh(None)


# -- FLOPs and bytes against JAX --------------------------------------------------------


def _lm_counts(arch, n=2, b=2, s=16):
    jcfg, tcfg = jreg.get_smoke(arch), treg.get_smoke(arch)
    assert jcfg.attn_chunk == tcfg.attn_chunk == 0
    np_params = jax.device_get(jt.init_params(jax.random.PRNGKey(0), jcfg))
    rng = np.random.default_rng(0)
    batch = {k: rng.integers(0, jcfg.vocab_size, (n, b, s)).astype(np.int32) for k in ("inputs", "targets")}
    jstack = jax.tree_util.tree_map(lambda x: jnp.stack([x] * n), np_params)
    f = jax.vmap(jax.value_and_grad(jt.make_loss_fn(jcfg)), in_axes=(0, 0, None))
    text = jax.jit(f).lower(jstack, {k: jnp.asarray(v) for k, v in batch.items()},
                            jax.random.PRNGKey(1)).compile().as_text()
    tstack = tree_map(lambda x: torch.stack([x] * n), params_from_numpy(np_params, "cpu"))
    grads = th._client_grads(tt.make_loss_fn(tcfg), None)
    _, got = opcount.count(grads, tstack, {k: torch.as_tensor(v) for k, v in batch.items()}, None, device="cpu")
    return hlo.analyze(text), got


def _mlp_counts():
    fields = ["data.dim=64", "model.hidden=256", "data.num_classes=10"]
    jspec, tspec = japi.ExperimentSpec.parse(fields), tapi.ExperimentSpec.parse(fields)
    np_params = jax.device_get(jspec.init_params(jax.random.PRNGKey(1)))
    jb, tb = japi._model_bundle(jspec), tspec.model_bundle("cpu")
    n = 8
    rng = np.random.default_rng(0)
    batch = {"inputs": rng.normal(size=(n, 16, 64)).astype(np.float32),
             "targets": rng.integers(0, 10, size=(n, 16)).astype(np.int32)}
    jopt, topt = joptim.sgd(0.1), toptim.sgd(0.1)
    jtopo, ttopo = jh.FedTopology(num_edges=2, clients_per_edge=4), th.FedTopology(num_edges=2, clients_per_edge=4)
    jstate = jh.init_state(jax.random.PRNGKey(0), jax.tree_util.tree_map(jnp.asarray, np_params), jopt, jtopo,
                           jh.HierFAVGConfig(kappa1=2, kappa2=2))
    tstate = th.init_state(torch.Generator().manual_seed(0), tspec.params_from_numpy(np_params, "cpu"), topt, ttopo,
                           th.HierFAVGConfig(kappa1=2, kappa2=2))
    text = jax.jit(jh.build_local_step(jb["loss"], jopt)).lower(
        jstate, {k: jnp.asarray(v) for k, v in batch.items()}).compile().as_text()
    _, got = opcount.count(th.build_local_step(tb["loss"], topt), tstate,
                           {k: torch.from_numpy(v) for k, v in batch.items()}, device="cpu")
    return hlo.analyze(text), got


CASES = {"granite-3-2b": lambda: _lm_counts("granite-3-2b"), "yi-9b": lambda: _lm_counts("yi-9b"),
         "recurrentgemma-9b": lambda: _lm_counts("recurrentgemma-9b"), "mlp_local_step": _mlp_counts}


@pytest.mark.parametrize("case", sorted(CASES))
def test_flops_match_jax_hlo(case):
    want, got = CASES[case]()
    gap = got.flops / want.flops - 1
    print(f"{case}: port {got.flops:.0f} FLOPs, JAX {want.flops:.0f}, gap {gap:+.2e}; "
          f"bytes port {got.hbm_bytes:.0f}, JAX {want.hbm_bytes:.0f} ({got.hbm_bytes / want.hbm_bytes:.3f}x)")
    assert want.flops > 0 and abs(gap) <= FLOP_RTOL


def test_the_byte_rules_count_what_each_op_moves():
    x = torch.zeros(64, 32)
    w = torch.zeros(32, 16)
    idx = torch.arange(8)
    upd = torch.ones(8, 32)
    f32 = 4

    def mm(x, w):
        return x @ w  # 64x32 + 32x16 read, 64x16 written

    def views(x):
        return x.t().reshape(32, 64)[:4].unsqueeze(0)  # views only

    def gather(x, idx):
        return x.index_select(0, idx)  # 2 x the 8 rows read and written

    def update(x, idx, upd):
        return x.index_add_(0, idx, upd)  # 2 x the update

    def alloc():
        return torch.empty(1000)

    cases = [(mm, (x, w), (64 * 32 + 32 * 16 + 64 * 16) * f32), (views, (x,), 0),
             (gather, (x, idx), 2 * 8 * 32 * f32), (update, (x.clone(), idx, upd), 2 * 8 * 32 * f32), (alloc, (), 0)]
    for fn, args, want in cases:
        _, got = opcount.count(fn, *args, device="cpu")
        assert got.hbm_bytes == want, fn.__name__
    _, s = opcount.count(mm, x, w, device="cpu")
    assert s.flops == 2 * 64 * 32 * 16
    assert s.memory["argument_size_in_bytes"] == (64 * 32 + 32 * 16) * f32
    assert s.memory["output_size_in_bytes"] == s.memory["temp_size_in_bytes"] == 64 * 16 * f32
    _, s = opcount.count(update, x.clone(), idx, upd, device="cpu")
    assert s.memory["alias_size_in_bytes"] == 64 * 32 * f32  # the result is the updated argument


def test_the_peak_counts_what_autograd_keeps_alive():
    def step(w, x):
        h = torch.tanh(x @ w)  # kept for the backward
        return torch.autograd.grad(h.sum(), w)[0]

    w, x = torch.zeros(32, 32, requires_grad=True), torch.zeros(128, 32)
    _, s = opcount.count(step, w, x, device="cpu")
    assert s.memory["temp_size_in_bytes"] >= 2 * 128 * 32 * 4  # x @ w and tanh of it live together


# -- the ring model and the axis classes -------------------------------------------------


@pytest.mark.parametrize("opcode", ["all-reduce", "all-gather", "reduce-scatter", "all-to-all",
                                    "collective-permute"])
@pytest.mark.parametrize("promoted", [False, True])
def test_the_ring_model_is_jax_s(opcode, promoted):
    for nbytes, size in ((4096.0, 16), (12.0, 2), (1e9, 32), (8.0, 1)):
        j = hlo.CollectiveRecord(opcode, nbytes, size, "model", 3.0, bf16_promoted=promoted)
        t = opcount.CollectiveRecord(opcode, nbytes, size, "model", 3.0, bf16_promoted=promoted)
        assert t.traffic_per_device == j.traffic_per_device and t.effective_bytes == j.effective_bytes


class _Device:
    def __init__(self, i):
        self.id = i


class _JaxMesh:
    """What JAX's ``mesh_axis_coords`` reads of a mesh: devices and axis
    names, row-major ids as the production meshes lay them."""

    def __init__(self, shape, axes):
        self.devices = np.vectorize(_Device)(np.arange(int(np.prod(shape))).reshape(shape))
        self.axis_names = axes


@pytest.mark.parametrize("shape,axes", [((16, 16), ("data", "model")), ((2, 16, 16), ("pod", "data", "model")),
                                        ((4, 1), ("data", "model"))])
def test_the_axis_classes_are_jax_s(shape, axes):
    jcoords = hlo.mesh_axis_coords(_JaxMesh(shape, axes))
    tcoords = opcount.mesh_axis_coords(_FakeMesh(**dict(zip(axes, shape))))
    grid = np.arange(int(np.prod(shape))).reshape(shape)
    groups = [grid.reshape(-1, shape[-1])[:1], np.moveaxis(grid, -2, -1).reshape(-1, shape[-2])[:1],
              grid.reshape(1, -1), grid.reshape(-1)[:1][None], grid.reshape(-1)[[0, 2]][None]]
    if len(shape) == 3:
        groups.append(np.moveaxis(grid, (0, 1), (1, 2)).reshape(-1, shape[0] * shape[1])[:1])
    for g in groups:
        assert opcount.classify_groups(g, tcoords) == hlo.classify_groups(g, jcoords), g


# -- collective counts on fake worlds ---------------------------------------------------------


def _dense_counts(mesh_shape):
    cfg = treg.get_smoke("yi-9b")  # a vocabulary that splits: the embedding and the logits are gathered
    L = cfg.num_layers
    with fake_world(int(np.prod(mesh_shape))):
        mesh = tmesh.make_host_mesh(mesh_shape, ("data", "model"), device=dryrun.FAKE_DEVICE)
        out = {}
        for kind, shape in (("prefill", ShapeSpec("p", 16, 2, "prefill")),
                            ("train", ShapeSpec("t", 16, 4, "train"))):
            cell = steps.build_cell(cfg, shape, mesh)
            sharding.reset_counts()
            _, summary = dryrun.counted(cell, mesh, cfg, dryrun.FAKE_DEVICE)
            out[kind] = (summary, dict(sharding.COUNTS), cell.meta)
    return L, out


@pytest.mark.parametrize("mesh_shape", [(1, 2), (2, 2)])
def test_collective_counts_follow_item_16s_formula(mesh_shape):
    L, out = _dense_counts(mesh_shape)
    summary, counts, _ = out["prefill"]
    assert summary.collective_counts() == {"all-reduce@model": 2 * L, "all-gather@model": 2}
    assert counts["tp_all_reduce"] == 2 * L and counts["tp_all_gather"] == 2
    summary, counts, meta = out["train"]
    assert meta["grad_accum"] == 1
    # 4L + 2 sums, the loss's max, the grad norm's sum; the embedding's gather
    assert summary.collective_counts() == {"all-reduce@model": 4 * L + 2 + 1 + 1, "all-gather@model": 1}
    assert (counts["tp_all_reduce"], counts["tp_all_reduce_max"], counts["tp_all_gather"],
            counts["tp_grad_norm"]) == (4 * L + 2, 1, 1, 1)
    assert all(c.group_size == 2 for c in summary.collectives)
    assert summary.kernels == {}  # no sync is due after one step of kappa (2, 2): K1 not charged


@pytest.mark.parametrize("kind", ["prefill", "decode", "train"])
def test_remade_meta_outputs_change_no_count(kind, monkeypatch):
    """The counter makes a repeated meta op's outputs from what the op made
    before (``opcount._MADE``): the counts equal those of every op run, on a
    first call (the layers repeat each other's ops) and a second."""
    cfg = treg.get_smoke("recurrentgemma-9b")  # attention, the RG-LRU scan (K8), a decode's caches
    shape = {"prefill": ShapeSpec("p", 16, 2, "prefill"), "decode": ShapeSpec("d", 16, 2, "decode"),
             "train": ShapeSpec("t", 16, 4, "train")}[kind]

    def summary():
        with fake_world(4):
            mesh = tmesh.make_host_mesh((2, 2), ("data", "model"), device=dryrun.FAKE_DEVICE)
            cell = steps.build_cell(cfg, shape, mesh)
            s = dryrun.counted(cell, mesh, cfg, dryrun.FAKE_DEVICE)[1]
        return (s.flops, s.hbm_bytes, [c.key() + (c.count,) for c in s.collectives], s.kernels, s.memory, s.ops,
                dict(s.per_module_flops))

    opcount._MADE.clear()
    first, second = summary(), summary()
    assert opcount._MADE
    monkeypatch.setattr(opcount, "_meta_key", lambda *a: None)
    assert first == second == summary()


def test_the_fake_world_is_gone_after_a_failing_test():
    with pytest.raises(RuntimeError):
        with fake_world(2):
            sharding.set_hint_mesh(object())
            raise RuntimeError("a failing test")
    assert not torch.distributed.is_initialized() and sharding.hint_mesh() is None


# -- F3: edges that span ranks; F4: JAX's refusal ----------------------------------------------


def _jax_span_reference():
    cfg = jreg.get_smoke(SPAN_ARCH)
    topo = jsh.topology_for(cfg, _FakeMesh(data=1))
    hier = cfg.fed.schedule()
    params = jt.init_params(jax.random.PRNGKey(0), cfg)
    rng = np.random.default_rng(0)
    shape = (topo.num_clients, SPAN_SHAPE[2] // topo.num_clients, SPAN_SHAPE[1])
    batches = [{k: rng.integers(0, cfg.vocab_size, size=shape).astype(np.int32) for k in ("inputs", "targets")}
               for _ in range(hier.kappa1 * hier.kappa2)]
    step = jax.jit(jh.build_train_step(jt.make_loss_fn(cfg), joptim.sgd(LR), topo, hier,
                                       jnp.ones((topo.num_clients,), jnp.float32)))
    state = jh.init_state(jax.random.PRNGKey(1), params, joptim.sgd(LR), topo, hier)
    after = []
    for b in batches:
        state, m = step(state, b)
        after.append(([np.asarray(x) for x in jax.tree_util.tree_leaves(jax.device_get(state.params))],
                      float(m["loss"])))
    return {"params": jax.device_get(params), "batches": batches, "after": after, "num_edges": topo.num_edges,
            "hier": (hier.kappa1, hier.kappa2)}


@pytest.fixture(scope="module")
def span_run():
    ref = _jax_span_reference()
    got = launch.spawn(ranks.span_train_cell, 4, "gloo",
                       (SPAN_ARCH, SPAN_SHAPE, ref["params"], ref["batches"], LR))
    return ref, got


def test_a_train_cell_whose_edges_span_ranks_tracks_jax(span_run):
    ref, got = span_run
    assert ref["num_edges"] == 2 and ref["hier"] == (2, 2)
    assert all(r["meta"]["edge_span"] == 2 and r["meta"]["sharded"] for r in got)
    for call, (want_params, want_loss) in enumerate(ref["after"]):
        losses = np.concatenate([r["losses"][call] for r in got])
        np.testing.assert_allclose(losses.mean(), want_loss, **METRIC_TOL, err_msg=f"call {call + 1} loss")
        for i, want in enumerate(want_params):
            have = np.concatenate([r["params"][call][i] for r in got])
            np.testing.assert_allclose(have, want, **STATE_TOL, err_msg=f"call {call + 1} leaf {i}")


def test_the_spanning_syncs_all_reduce_over_data(span_run):
    _, got = span_run
    for r in got:
        # kappa (2, 2): call 2 syncs the edges (one all-reduce over the edge's
        # 2 ranks), call 4 the cloud (one over the 4)
        assert [[x for x in rec if x[1] == "data"] for rec in r["records"]] == [
            [], [("all-reduce", "data", 2)], [], [("all-reduce", "data", 4)]]
        assert r["counts"]["edge_all_reduce"] == 1 and r["counts"]["all_reduce"] == 1


def test_a_placement_neither_rule_covers_is_refused_by_name():
    import dataclasses

    from test_torch_tensor_parallel import rank_mesh_stand_in

    cfg = treg.get_smoke(SPAN_ARCH)
    cfg = dataclasses.replace(cfg, fed=dataclasses.replace(cfg.fed, edges_per_pod=2, clients_per_edge=3))
    with pytest.raises(ValueError, match=r"whole edges on each rank, or each edge of a two-level tree over whole "
                                         r"ranks: 6 clients in 3 contiguous blocks over 2 edge\(s\) .* fit neither"):
        steps.build_train_cell(cfg, ShapeSpec("t", 8, 6, "train"), rank_mesh_stand_in((3, 1)))


def test_f4_a_client_count_the_client_axes_do_not_divide_gives_jax_s_words():
    from test_torch_tensor_parallel import rank_mesh_stand_in

    jcfg, tcfg = jreg.get_config("deepseek-v3-671b"), treg.get_config("deepseek-v3-671b")
    mesh = _FakeMesh(data=16, model=16)
    n = jsh.topology_for(jcfg, mesh).num_clients
    with pytest.raises(ValueError) as je:
        jsh.fed_rules(jcfg, mesh)._client_member(n)
    with pytest.raises(ValueError) as te:
        steps.build_train_cell(tcfg, ShapeSpec("train_4k", 4096, 256, "train"), rank_mesh_stand_in((16, 16)))
    assert str(te.value) == str(je.value)
    assert "stacked client axis of size 1 is not divisible" in str(te.value)


# -- the kernels' fake branch --------------------------------------------------------------------


def _kernel_calls(device):
    g = torch.Generator().manual_seed(0)

    def t(*shape, dtype=torch.float32):
        return torch.randn(*shape, generator=g).to(dtype).to(device)

    x, w = t(8, 32), t(8).abs()
    q, k = t(2, 16, 4, 8), t(2, 16, 2, 8)
    a, b, h0 = t(2, 16, 8).sigmoid(), t(2, 16, 8), t(2, 8)
    return {
        "grouped_mean": (lambda: ha.grouped_mean(x, w, 2), lambda: ha.grouped_mean_plain(x, w, 2)),
        "segment_mean": (lambda: ha.segment_mean(x, w, [0, 0, 0, 1, 1, 2, 2, 2], 3),
                         lambda: ha.segment_mean_plain(x, w, np.array([0, 0, 0, 1, 1, 2, 2, 2]), 3)),
        "flash_attention": (lambda: fa.attention(q, k, k, window=5), lambda: fa.attention_plain(q, k, k, window=5)),
        "rglru_scan": (lambda: rg.rglru_scan(a, b, h0)[0], lambda: rg.rglru_scan_plain(a, b, h0, chunk=rg.CHUNK)[0]),
    }


def test_the_kernels_take_the_fake_branch_only_for_a_fake_input():
    for m in (ha, fa, rg):
        m.reset_launch_counts()
    for name, (kernel, _) in _kernel_calls("meta").items():
        out, s = opcount.count(kernel, device="meta")
        assert out.is_meta and s.kernels[name][0] == 1, name
        assert s.kernels[name][2] > 0 and s.hbm_bytes == s.kernels[name][2], name
    assert sum(v for m in (ha, fa, rg) for v in m.LAUNCHES.values()) == 0
    g = torch.Generator().manual_seed(1)
    q, k = torch.randn(2, 16, 4, 8, generator=g), torch.randn(2, 16, 2, 8, generator=g)
    for causal in (True, False):  # the charge follows the mask the call asks for
        _, s = opcount.count(lambda: fa.attention(q.to("meta"), k.to("meta"), k.to("meta"), causal=causal),
                             device="meta")
        assert s.kernels["flash_attention"][:2] == [1, 2 * 16 * (136 if causal else 256) * 2 * 4], causal
        out, s = opcount.count(lambda: fa.attention(q, k, k, causal=causal), device="cpu")
        assert torch.equal(out, fa.attention_plain(q, k, k, causal=causal)) and s.kernels == {}, causal
    for name, (kernel, _) in _kernel_calls("meta").items():  # meta outside the dry run's counter: refused
        with pytest.raises(ValueError, match="CPU .* or CUDA"):
            opcount.count(kernel, device="cpu")
    for name, (kernel, plain) in _kernel_calls("cpu").items():  # real tensors: the plain versions, no charge
        out, s = opcount.count(kernel, device="cpu")
        assert not opcount.is_fake(out) and torch.equal(out, plain()) and s.kernels == {}, name


def test_a_folded_loop_counts_as_every_iteration_and_refuses_real_tensors():
    def body(x, w, loop):
        for _ in loop:
            x = x @ w + 1
        return x

    x, w = torch.empty(4, 8, device="meta"), torch.empty(8, 8, device="meta")
    _, folded = opcount.count(lambda: body(x, w, opcount.iterations(range(3))), device="meta")
    _, every = opcount.count(lambda: body(x, w, range(3)), device="meta")
    assert folded.flops == every.flops == 3 * 2 * 4 * 8 * 8
    assert (folded.hbm_bytes, folded.ops) == (every.hbm_bytes, every.ops)
    xr, wr = torch.ones(4, 8), torch.eye(8)
    with pytest.raises(RuntimeError, match="folded loop stands for its iterations on meta tensors only"):
        opcount.count(lambda: body(xr, wr, opcount.iterations(range(3))), device="meta")
    out, s = opcount.count(lambda: body(xr, wr, opcount.iterations(range(3))), device="cpu")  # not folded
    assert torch.equal(out, torch.full((4, 8), 4.0)) and s.flops == 3 * 2 * 4 * 8 * 8


@pytest.mark.parametrize("sq,sk", [(16, 16), (8, 24), (24, 8)])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("window", [0, 5, 40])
def test_attention_work_counts_the_pairs_the_mask_leaves(sq, sk, causal, window):
    qpos, kpos = torch.arange(sq)[:, None], torch.arange(sk)[None, :]
    mask = torch.ones(sq, sk, dtype=torch.bool)
    if causal:  # attention_plain's rule
        mask &= kpos <= qpos
    if window > 0:
        mask &= (qpos - kpos) < window
    pairs = int(mask.sum())
    assert opcount.attention_pairs(sq, sk, causal, window) == pairs
    flops, nbytes = opcount.attention_work(2, sq, sk, 4, 2, 8, 6, causal, window, 4)
    assert flops == 2 * (8 + 6) * pairs * 2 * 4
    assert nbytes == (2 * sq * 4 * 8 + 2 * sk * 2 * (8 + 6) + 2 * sq * 4 * 6) * 4


def test_the_card_route_takes_the_kernels_on_meta_tensors():
    from repro_torch.models import layers

    meta = torch.empty(2, device="meta")
    assert not layers._on_card(meta) and not layers._on_card(torch.empty(2))  # no counter: not the card's
    assert opcount.count(lambda: layers._on_card(meta), device="meta")[0]
    assert not opcount.count(lambda: layers._on_card(meta), device="cpu")[0]
    q = torch.empty(1, 16, 2, 8, device="meta")
    cfg = treg.get_smoke("granite-3-2b")
    _, s = opcount.count(lambda: layers._full_attention(q, q, q, cfg, None, default_positions=True), device="meta")
    assert s.kernels["flash_attention"][0] == 1


# -- end to end ------------------------------------------------------------------------------------


def test_the_dry_run_writes_jax_s_keys_and_the_report_reads_them(tmp_path, capsys):
    out = str(tmp_path / "art")
    rc = dryrun.main(["--arch", "granite-3-2b,deepseek-v3-671b", "--shape", "train_4k", "--smoke",
                      "--host-mesh", "2,2", "--out", out, "--jobs", "2"])  # a process a cell
    assert rc == 0 and not torch.distributed.is_initialized() and sharding.hint_mesh() is None
    with open(os.path.join(out, "granite-3-2b__train_4k__host_2x2.json")) as f:
        rec = json.load(f)
    keys = {"arch", "shape", "kind", "mesh", "chips", "memory", "meta", "roofline", "phases"}
    assert keys | {"ops", "trace_s", "rank", "counted"} == set(rec)
    assert rec["counted"] == dryrun.COUNTED and rec["rank"] == 0 and rec["chips"] == 4
    assert set(rec["memory"]) == {"argument_size_in_bytes", "output_size_in_bytes", "temp_size_in_bytes",
                                  "alias_size_in_bytes", "generated_code_size_in_bytes"}
    assert rec["ops"]["flops_per_device"] > 0 and rec["roofline"]["flops_per_device"] == rec["ops"]["flops_per_device"]
    # 4 clients on 2 data ranks: whole edges a rank, so the edge sync is rank-local
    ph = rec["phases"]
    assert set(ph["edge_ops"]["coll_breakdown"]) <= {"model"} and ph["cloud_ops"]["coll_counts"] == {
        "all-reduce@data": 1}
    assert ph["edge_ops"]["kernels"]["grouped_mean"]["calls"] > 0
    with open(os.path.join(out, "deepseek-v3-671b__train_4k__host_2x2.json")) as f:
        refused = json.load(f)
    assert "stacked client axis of size 1 is not divisible" in refused["refused"]
    capsys.readouterr()
    assert roofline_report.main(["--out", out]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert any(ln.startswith("roofline,granite-3-2b-smoke,train_4k,host_2x2,") and "amortized_coll_ms=" in ln
               for ln in lines)
    assert any(ln.startswith("refused,deepseek-v3-smoke,train_4k,host_2x2,stacked client axis") for ln in lines)


def _artifacts(out):
    recs = {}
    for name in sorted(os.listdir(out)):
        with open(os.path.join(out, name)) as f:
            rec = json.load(f)
        rec.pop("trace_s", None)
        recs[name] = rec
    return recs


def test_cells_counted_side_by_side_equal_cells_counted_in_turn(tmp_path):
    """``--jobs 3``: this process counts the train cell while two spawned
    ones count the prefill and the decode; every artifact but its seconds
    equals the one a single process writes."""
    argv = ["--arch", "yi-9b", "--smoke", "--host-mesh", "2,2"]
    assert dryrun.main(argv + ["--out", str(tmp_path / "turn")]) == 0
    assert dryrun.main(argv + ["--out", str(tmp_path / "side"), "--jobs", "3"]) == 0
    assert not torch.distributed.is_initialized() and sharding.hint_mesh() is None
    turn, side = _artifacts(tmp_path / "turn"), _artifacts(tmp_path / "side")
    assert len(turn) == 3 and {r["kind"] for r in turn.values()} == {"train", "prefill", "decode"}
    assert side == turn


def test_the_report_starts_without_torch():
    """The report reads JSON alone: the package imports torch on first use
    of ``resolve_device``, so the report's process never loads it."""
    import subprocess

    code = ("import sys; import repro_torch.experiments.roofline_report; print('torch' in sys.modules); "
            "from repro_torch import resolve_device; print('torch' in sys.modules, resolve_device('cpu'))")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(p for p in sys.path if p))
    out = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["False", "True", "cpu"]


def test_the_caller_is_found_from_a_thread_with_no_python_frame_above():
    """Autograd's device threads call the counter's dispatch with no Python
    frame above it: naming the calling module must not need one."""
    import _thread
    import threading

    done, out = threading.Event(), []

    def dispatch_like():  # the first Python frame of its thread, as the counter's dispatch there
        try:
            out.append(opcount._caller())
        except Exception as e:  # noqa: BLE001 - reported by the assertion below
            out.append(e)
        done.set()

    _thread.start_new_thread(dispatch_like, ())
    assert done.wait(30)
    assert out == ["torch"]
