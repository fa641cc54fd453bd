"""The launch cells in the port against the JAX package, on the CPU
(ROADMAP.md Queue 1 items 12 and 15): ``launch/mesh.py``, ``specs.py`` and
``steps.py``.

- ``specs``: every stand-in's shape, dtype kind and spec, and the train
  batch's ``grad_accum``, equal to JAX's ``specs.py`` for every registry
  smoke config and shape on several meshes (JAX's shardings read as their
  ``PartitionSpec`` on a fake mesh).
- The train cell on 2 gloo ranks (``dist.launch.spawn``; 2 clients a rank,
  4 microbatches a step) over one cloud interval against JAX's
  ``build_train_cell`` run with concrete arrays on a 2-device host mesh
  (a subprocess under ``XLA_FLAGS=--xla_force_host_platform_device_count=4``),
  and the cloud sync as the one all-reduce of the interval.
- The prefill and decode cells of the smoke MoE (MLA + 4 experts) on 2
  expert-parallel ranks, one request a rank, against JAX's cells under a
  2-device hint mesh: logits of the prefill and of three decode steps, one
  dispatch and one combine all-to-all per MoE call, half the experts a
  rank; requests that do not split over the data axis are refused.
- A "model" axis larger than 1: every family's cells build there (item
  16b); a world that does not match the mesh raises JAX's ValueError
  text.

Tolerances: JAX's mesh tolerances for the train cell (params ``rtol=3e-6,
atol=2e-7``, loss and grad norm ``rtol=1e-5``); logits ``rtol=atol=1e-5``
(``tests/test_torch_moe_mla.py``'s).
"""
import dataclasses
import os
import pickle
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro.configs import registry as jreg
from repro.configs.base import LM_SHAPES as JSHAPES
from repro.configs.base import ShapeSpec as JShapeSpec
from repro.launch import mesh as jmesh
from repro.launch import specs as jspecs
from repro_torch.configs import registry as treg
from repro_torch.configs.base import ShapeSpec
from repro_torch.dist import launch
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import specs as tspecs
from repro_torch.launch import steps
from repro_torch.tree import leaves

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_mp_ranks as ranks  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TRAIN_ARCH, TRAIN_SHAPE, LR = "granite-3-2b", ("train_cut", 8, 16, "train"), 0.05
SERVE_ARCH, PROMPT, MAX_LEN, DECODE = "deepseek-v3-671b", 16, 24, 3
STATE_TOL = dict(rtol=3e-6, atol=2e-7)
METRIC_TOL = dict(rtol=1e-5, atol=1e-7)
LOGITS = dict(rtol=1e-5, atol=1e-5)


class _FakeMesh:
    def __init__(self, **shape):
        self.axis_names = tuple(shape)
        self.shape = dict(shape)


SHAPES = list(JSHAPES) + [JShapeSpec("train_cut", 64, 128, "train"), JShapeSpec("prefill_2", 64, 2, "prefill")]


@pytest.mark.parametrize("mesh_shape", [dict(data=2, model=1), dict(data=16, model=16),
                                        dict(pod=2, data=16, model=16)])
def test_specs_equal_jax(mesh_shape, monkeypatch):
    monkeypatch.setattr(jspecs, "NamedSharding", lambda mesh, spec: spec)
    monkeypatch.setattr(jspecs, "_sds", lambda shape, dtype, sharding=None: (tuple(shape), np.dtype(dtype).kind))
    mesh = _FakeMesh(**mesh_shape)
    for arch in sorted(treg.all_configs()):
        jcfg, tcfg = jreg.get_smoke(arch), treg.get_smoke(arch)
        for js in SHAPES:
            ts = ShapeSpec(js.name, js.seq_len, js.global_batch, js.kind)
            try:
                want = jspecs.input_specs(jcfg, js, mesh)
            except ValueError as e:
                with pytest.raises(ValueError) as te:
                    tspecs.input_specs(tcfg, ts, mesh)
                assert str(te.value) == str(e)
                continue
            got = tspecs.input_specs(tcfg, ts, mesh)
            assert sorted(got) == sorted(want)
            for k in want:
                kind = {torch.int32: "i"}.get(got[k].dtype, "f")
                assert (tuple(got[k].shape), kind) == want[k], (arch, js.name, k)
                assert got[k].device.type == "meta"
            if js.kind == "train":
                _, jsh, jaccum = jspecs.train_batch_specs(jcfg, js, mesh)
                _, tsh, taccum = tspecs.train_batch_specs(tcfg, ts, mesh)
                assert taccum == jaccum and all(tuple(tsh[k]) == tuple(jsh[k]) for k in jsh)
            elif js.kind == "prefill":
                assert tuple(tspecs.prefill_request_specs(tcfg, ts, mesh)[1]) == tuple(
                    jspecs.prefill_request_specs(jcfg, js, mesh)[1])
            else:
                tsh, jsh = tspecs.decode_request_specs(tcfg, ts, mesh)[1], jspecs.decode_request_specs(jcfg, js, mesh)[1]
                assert all(tuple(tsh[k]) == tuple(jsh[k]) for k in jsh)


def test_lm100m_train_cut_gives_accum_two_of_four():
    batch, specs, accum = tspecs.train_batch_specs(treg.get_config("lm-100m"), ShapeSpec("train_cut", 64, 128, "train"),
                                                  _FakeMesh(data=2))
    assert accum == 2 and tuple(batch["inputs"].shape) == (2, 16, 4, 64)
    assert tuple(specs["inputs"]) == (None, "data", None, None)


def test_a_model_axis_larger_than_one_is_refused_naming_item_16():
    """Item 16 brought the dense families to a "model" axis larger than 1
    and item 16b the rest: every family's cells build on a (2, 2) mesh
    (``tests/test_torch_tensor_parallel_families.py`` holds their numbers
    to JAX's)."""
    from test_torch_tensor_parallel import rank_mesh_stand_in

    mesh = rank_mesh_stand_in((2, 2))
    for build in (steps.build_train_cell, steps.build_prefill_cell, steps.build_decode_cell):
        shape = ShapeSpec("s", 8, 16 if build is steps.build_train_cell else 2,
                          {steps.build_train_cell: "train", steps.build_prefill_cell: "prefill"}.get(build, "decode"))
        for arch in ("recurrentgemma-9b", "xlstm-350m", SERVE_ARCH, TRAIN_ARCH):
            cfg = treg.get_smoke(arch)
            if build is steps.build_train_cell:  # 8 clients: whole edges on each of the 2 data ranks
                cfg = dataclasses.replace(cfg, fed=dataclasses.replace(cfg.fed, edges_per_pod=2, clients_per_edge=4))
            assert build(cfg, shape, mesh).meta["model"] == 2, (build, arch)


def test_replicated_requests_are_refused_under_the_expert_parallel_moe():
    with pytest.raises(ValueError, match=r"3 request\(s\) do not split over the data axis of 2"):
        steps.build_prefill_cell(treg.get_smoke(SERVE_ARCH), ShapeSpec("p", 16, 3, "prefill"), _FakeMesh(data=2))
    assert steps.build_prefill_cell(treg.get_smoke(SERVE_ARCH), ShapeSpec("p", 16, 4, "prefill"),
                                    _FakeMesh(data=2)).meta["ep_mode"] == "ep_data"


def test_a_world_that_does_not_match_the_mesh_raises_jax_words():
    with pytest.raises(ValueError) as je:
        jmesh.make_host_mesh((2,), ("data",))
    with pytest.raises(ValueError) as jp:
        jmesh.make_production_mesh()
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0, world_size=1)
    try:
        with pytest.raises(ValueError) as te:
            tmesh.make_host_mesh((2,), ("data",), device="cpu")
        with pytest.raises(ValueError) as tp:
            tmesh.make_production_mesh(device="cpu")
        one = tmesh.make_host_mesh((1, 1), ("data", "model"), device="cpu")
        assert one.shape == {"data": 1, "model": 1} and one.axis_index("data") == 0
    finally:
        dist.destroy_process_group()
    assert str(te.value) == str(je.value) == "need 2 devices, have 1"
    assert str(tp.value) == str(jp.value)


def test_the_aggregation_cells_track_jax_on_one_device():
    """``build_aggregation_cells``: the edge and the cloud sync as cells of
    their own, on one device, against JAX's on a one-device mesh, from the
    same stacked state (clients apart)."""
    from repro.core.hierfavg import init_state as jinit_state
    from repro.dist import sharding as jsh
    from repro.launch import steps as jsteps
    from repro.models import transformer as jt
    from repro.optim import sgd as jsgd
    from repro_torch import models as tmodels

    cfg, tcfg = jreg.get_smoke(TRAIN_ARCH), treg.get_smoke(TRAIN_ARCH)
    mesh = jmesh.make_host_mesh((1, 1), ("data", "model"))
    jedge, jcloud = jsteps.build_aggregation_cells(cfg, mesh)
    tedge, tcloud = steps.build_aggregation_cells(tcfg, None, device="cpu")
    assert (tedge.meta, tcloud.meta) == (jedge.meta, jcloud.meta)
    params = jt.init_params(jax.random.PRNGKey(0), cfg)
    state = jinit_state(jax.random.PRNGKey(1), params, jsgd(1e-3), jsh.topology_for(cfg, mesh), cfg.fed.schedule())
    rng = np.random.default_rng(3)
    stacked = jax.tree_util.tree_map(lambda x: x + rng.normal(size=x.shape).astype(np.float32) * 0.1, state.params)
    state = state._replace(params=stacked)
    np_stacked = jax.device_get(stacked)
    for jcell, tcell in ((jedge, tedge), (jcloud, tcloud)):
        want = jax.tree_util.tree_leaves(jax.device_get(jcell.fn(state).params))
        tstate = steps.init_train_state(tcfg, None, tmodels.params_from_numpy(params, "cpu"), torch.Generator())
        tstate = tstate._replace(params=tmodels.params_from_numpy(np_stacked, "cpu"))
        got = list(leaves(tcell.fn(tstate).params))
        assert len(got) == len(want)
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), w, rtol=1e-6, atol=1e-7, err_msg=tcell.meta["kind"])


# ---------------------------------------------------------------------------
# the cells against JAX's, on 2 ranks
# ---------------------------------------------------------------------------


def _jax_cells_main(out_path):
    """JAX's train cell over one cloud interval and its serving cells, with
    concrete arrays on a 2-device host mesh (run with four host devices)."""
    from repro.core.hierfavg import init_state
    from repro.dist import sharding as jsh
    from repro.launch import steps as jsteps
    from repro.models import transformer as jt
    from repro.optim import sgd

    mesh = jmesh.make_host_mesh((2,), ("data",))
    out = {}
    cfg = jreg.get_smoke(TRAIN_ARCH)
    cell = jsteps.build_train_cell(cfg, JShapeSpec(*TRAIN_SHAPE), mesh, lr=LR, donate=False)
    topo = jsh.topology_for(cfg, mesh)
    params = jt.init_params(jax.random.PRNGKey(0), cfg)
    state = init_state(jax.random.PRNGKey(1), params, sgd(LR), topo, cfg.fed.schedule())
    state = jax.device_put(state, cell.arg_shardings[0])
    rng = np.random.default_rng(0)
    shape = cell.arg_structs[1]["inputs"].shape
    steps_ = cell.meta["kappa1"] * cell.meta["kappa2"]
    batches = [{k: rng.integers(0, cfg.vocab_size, size=shape).astype(np.int32) for k in ("inputs", "targets")}
               for _ in range(steps_)]
    metrics = []
    for b in batches:
        state, m = cell.fn(state, jax.device_put(b, cell.arg_shardings[1]))
        metrics.append((float(m["loss"]), float(m["grad_norm"]), int(m["step"])))
    out["train"] = {"params": jax.device_get(params), "batches": batches, "metrics": metrics,
                    "final": [np.asarray(x) for x in jax.tree_util.tree_leaves(jax.device_get(state.params))],
                    "accum": cell.meta["grad_accum"]}

    cfg = jreg.get_smoke(SERVE_ARCH)
    params = jt.init_params(jax.random.PRNGKey(2), cfg)
    prompts = rng.integers(0, cfg.vocab_size, size=(2, PROMPT)).astype(np.int32)
    jsh.set_hint_mesh(mesh)
    try:
        assert jsh.moe_ep_mode(cfg.moe.num_experts) == "ep_data"
        pre = jsteps.build_prefill_cell(cfg, JShapeSpec("prefill", MAX_LEN, 2, "prefill"), mesh)
        dec = jsteps.build_decode_cell(cfg, JShapeSpec("decode", MAX_LEN, 2, "decode"), mesh, donate=False)
        logits, caches = pre.fn(params, prompts)
        serve = {"params": jax.device_get(params), "prompts": prompts, "prefill": np.asarray(logits), "decode": []}
        tokens = []
        for j in range(DECODE):
            tok = np.asarray(jax.numpy.argmax(logits, axis=-1)).astype(np.int32)
            tokens.append(tok)
            logits, caches = dec.fn(params, caches, tok, np.full((2,), PROMPT + j, np.int32))
            serve["decode"].append(np.asarray(logits))
        serve["tokens"] = np.stack(tokens, axis=1)
    finally:
        jsh.set_hint_mesh(None)
    out["serve"] = serve
    pickle.dump(out, open(out_path, "wb"))


@pytest.fixture(scope="module")
def cells(tmp_path_factory):
    d = tmp_path_factory.mktemp("cells")
    env = {**os.environ, "XLA_FLAGS": "--xla_force_host_platform_device_count=4", "JAX_PLATFORMS": "cpu",
           "PYTHONPATH": os.path.join(ROOT, "src")}
    code = ("import sys; sys.path.insert(0, sys.argv[2]); import test_torch_launch_cells as t; "
            "t._jax_cells_main(sys.argv[1])")
    subprocess.run([sys.executable, "-c", code, str(d / "jax.pkl"), os.path.join(ROOT, "tests")], env=env,
                   cwd=ROOT, check=True, timeout=600)
    ref = pickle.load(open(d / "jax.pkl", "rb"))
    tr, sv = ref["train"], ref["serve"]
    train = launch.spawn(ranks.train_cell, 2, "gloo", (TRAIN_ARCH, TRAIN_SHAPE, tr["params"], tr["batches"], LR))
    serve = launch.spawn(ranks.serve_cells, 2, "gloo", (SERVE_ARCH, sv["params"], sv["prompts"], sv["tokens"],
                                                        MAX_LEN))
    return ref, train, serve


def test_the_train_cell_on_two_ranks_tracks_jax(cells):
    ref, train, _ = cells
    tr = ref["train"]
    assert tr["accum"] == train[0]["meta"]["grad_accum"] == 4 and train[0]["meta"]["sharded"]
    for j, (loss, gnorm, step) in enumerate(tr["metrics"]):
        losses = np.concatenate([r["losses"][j] for r in train])
        gsq = np.concatenate([r["gsq"][j] for r in train])
        np.testing.assert_allclose(losses.mean(), loss, **METRIC_TOL, err_msg=f"step {step} loss")
        np.testing.assert_allclose(np.sqrt(gsq.sum()), gnorm, **METRIC_TOL, err_msg=f"step {step} grad_norm")
    for i, want in enumerate(tr["final"]):
        got = np.concatenate([r["params"][i] for r in train])
        np.testing.assert_allclose(got, want, **STATE_TOL, err_msg=f"leaf {i}")
    for r in train:  # 4 steps of kappa (2, 2): one cloud sync, one all-reduce
        assert r["counts"]["all_reduce"] == 1 and r["counts"]["all_to_all"] == 0


def test_the_serving_cells_on_two_expert_parallel_ranks_track_jax(cells):
    ref, _, serve = cells
    sv = ref["serve"]
    cfg = treg.get_smoke(SERVE_ARCH)
    whole = sum(int(np.prod(x.shape)) for x in leaves(steps.structs(lambda: steps._init_params(cfg))))
    moe_layers = cfg.num_layers
    per_expert = 3 * cfg.d_model * cfg.moe.d_ff_expert
    for r in serve:
        assert r["ep_mode"] == "ep_data"
        assert r["held"] == whole - moe_layers * (cfg.moe.num_experts // 2) * per_expert  # half the experts
        assert r["prefill_counts"]["all_to_all"] == 2 * moe_layers
        assert r["decode_counts"]["all_to_all"] == 2 * moe_layers  # the last decode step's
    np.testing.assert_allclose(np.concatenate([r["prefill"] for r in serve]), sv["prefill"], **LOGITS)
    for j in range(DECODE):
        np.testing.assert_allclose(np.concatenate([r["decode"][j] for r in serve]), sv["decode"][j], **LOGITS,
                                   err_msg=f"decode step {j}")
