"""The model-parallel half of ``dist.sharding`` in the port against the JAX
package, on the CPU (ROADMAP.md Queue 1 item 12, second half).

- ``ShardingRules`` (``fed_rules`` / ``serve_rules``): every parameter spec
  of every registry smoke config, stacked and not, and the batch, request
  and cache specs, equal to JAX's ``PartitionSpec`` members on
  ("data", "model") and ("pod", "data", "model") meshes of several sizes
  (JAX's ``_FakeMesh`` idiom, ``tests/test_sharded.py:143``), but for the
  tensor-parallel layout's named differences
  (``test_torch_tensor_parallel.DIFFERENCES``: row-parallel outputs, whole
  norms, latents, router and ``w_up``, the recurrent cells' heads and
  channels, a shared KV head, and where ``refuse_model_axis`` refuses an
  item-16b family's config, a named leaf whose split dim does not divide
  the axis kept whole);
  the client axis's ValueError word for word; ``topology_for``; a spec's
  slice.
- The hint mesh: ``hint`` is the identity, ``hint_data_groups`` and
  ``moe_ep_mode`` follow JAX's table, a "model" axis larger than 1 is
  installed, and every family passes on it (item 16b).
- ``moe_apply`` at G = 2 in one process (all experts on the rank) and over
  2 expert-parallel gloo ranks (E/P experts a rank, one all-to-all each way
  and one all-reduce of the router statistics per call) against JAX's
  ``moe_apply`` under a 2-device and a (2, 2) host hint mesh, made in a
  subprocess under ``XLA_FLAGS=--xla_force_host_platform_device_count=4``;
  the aux loss; a control in which two ranks swap their expert slices must
  fail.

Tolerance: the MoE's output ``rtol=1e-5`` and ``atol`` 1e-6 of
max(1, max |y|) (``tests/test_torch_moe_mla.py``'s layer tolerance: the
smoke MoE's outputs reach |y| ~ 100), the aux loss ``rtol=1e-5,
atol=1e-6``.
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

from repro.configs import registry as jreg
from repro.dist import sharding as jsh
from repro_torch.configs import registry as treg
from repro_torch.dist import launch, sharding
from repro_torch.launch import steps
from repro_torch.models import layers as tlayers
from repro_torch.tree import leaves

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_mp_ranks as ranks  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCH = "deepseek-v3-671b"  # the smoke MoE: 4 experts, top 2, one shared
T = 64


class _FakeMesh:
    def __init__(self, **shape):
        self.axis_names = tuple(shape)
        self.shape = dict(shape)


MESHES = [dict(data=2, model=2), dict(data=4, model=1), dict(data=16, model=16),
          dict(pod=2, data=2, model=2), dict(pod=2, data=16, model=16)]


def _layer_close(got, want, err_msg=""):
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(np.asarray(got, np.float32), want, rtol=1e-5,
                               atol=1e-6 * max(1.0, float(np.abs(want).max())), err_msg=err_msg)


def _jax_shapes(cfg):
    from repro.models import transformer as jt

    return jax.eval_shape(lambda: jt.init_params(jax.random.PRNGKey(0), cfg))


@pytest.mark.parametrize("arch", sorted(treg.all_configs()))
def test_rules_give_jax_members_for_every_leaf(arch, monkeypatch):
    from test_torch_tensor_parallel import FAMILIES  # tensor parallel since item 16b

    monkeypatch.setattr(jsh, "NamedSharding", lambda mesh, spec: spec)  # JAX's specs on a fake mesh
    is_spec = lambda x: isinstance(x, jsh.P)  # noqa: E731
    jcfg, tcfg = jreg.get_smoke(arch), treg.get_smoke(arch)
    jtree = _jax_shapes(jcfg)
    tstruct = steps.structs(lambda: steps._init_params(tcfg))
    assert [tuple(x.shape) for x in leaves(tstruct)] == [tuple(x.shape) for x in jax.tree_util.tree_leaves(jtree)]
    for shape in MESHES:
        mesh = _FakeMesh(**shape)
        refused = arch in FAMILIES and _refused(mesh, tcfg)
        n = mesh.shape.get("pod", 1) * mesh.shape["data"] * 2
        jstacked = jax.tree_util.tree_map(lambda x: jax.ShapeDtypeStruct((n,) + x.shape, x.dtype), jtree)
        tstacked = _stack(tstruct, n)
        for jrules, trules in ((jsh.fed_rules(jcfg, mesh), sharding.fed_rules(tcfg, mesh)),
                               (jsh.serve_rules(jcfg, mesh), sharding.serve_rules(tcfg, mesh))):
            jt, tt = (jstacked, tstacked) if jrules.client_axes else (jtree, tstruct)
            want = jax.tree_util.tree_leaves(jrules.params_shardings(jt), is_leaf=is_spec)
            got = list(leaves(trules.params_shardings(tt)))
            names = list(_leaf_names(tt))
            assert len(got) == len(want) == len(names), (arch, shape)
            for name, g, w in zip(names, got, want):
                assert tuple(g) == tuple(w) or _named_difference(name, tuple(g), tuple(w)) or (
                    refused and _kept_whole(name, tuple(g), tuple(w))), (arch, shape, name, g, w)
            if jrules.client_axes:
                for s, accum in (((n, 4, 16), False), ((n,), False), ((3, n, 2, 16, 8), True)):
                    assert tuple(trules.batch_spec(s, has_accum=accum)) == tuple(jrules.batch_spec(s, has_accum=accum))
            for s in ((n, 4, 16), (3, n, 2, 16, 8), (n,), (5, 7)):
                assert tuple(trules.request_spec(s)) == tuple(jrules.request_spec(s))
            cshapes = ((4, 16, 8), (3, 5), (2, 2, 40, 16))
            want = jax.tree_util.tree_leaves(jrules.caches_shardings(
                [jax.ShapeDtypeStruct(c, np.float32) for c in cshapes]), is_leaf=is_spec)
            got = list(leaves(trules.caches_shardings([torch.empty(c, device="meta") for c in cshapes])))
            assert [tuple(g) for g in got] == [tuple(w) for w in want]


def _refused(mesh, cfg) -> bool:
    """Whether ``refuse_model_axis`` refuses ``cfg`` on ``mesh`` (a head
    count or width that does not split over its "model" axis)."""
    try:
        sharding.refuse_model_axis(mesh, cfg)
    except ValueError:
        return True
    return False


def _kept_whole(name, got, want) -> bool:
    """A leaf of a named kind whose dim the port splits does not divide the
    "model" axis (xlstm-350m's 4 heads over 16 ranks, a config
    ``refuse_model_axis`` refuses there): the port keeps it whole where JAX
    splits another dim; every other member equals JAX's."""
    from test_torch_tensor_parallel import DIFFERENCES

    named = any(name in names for names in DIFFERENCES.values())
    return named and "model" not in got and got == tuple(None if m == "model" else m for m in want)


def _leaf_names(tree, name=None):
    """Each leaf's key, in ``leaves`` order."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaf_names(tree[k], k)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaf_names(v, name)
    else:
        yield name


def _named_difference(name, got, want) -> bool:
    """The tensor-parallel layout's differences from JAX's specs (ROADMAP.md
    "Differences by design"), as ``tests/test_torch_tensor_parallel.py``
    names them."""
    from test_torch_tensor_parallel import layout_difference

    return layout_difference(name, got, want) is not None


def _stack(tree, n):
    from repro_torch.tree import tree_map

    return tree_map(lambda x: torch.empty((n,) + tuple(x.shape), dtype=x.dtype, device="meta"), tree)


def test_client_axis_error_and_topology_equal_jax():
    mesh = _FakeMesh(pod=2, data=2, model=2)
    with pytest.raises(ValueError) as je:
        jsh.fed_rules(None, mesh)._client_member(6)
    with pytest.raises(ValueError) as te:
        sharding.fed_rules(None, mesh)._client_member(6)
    assert str(te.value) == str(je.value)
    assert sharding.fed_rules(None, mesh)._client_member(8) == jsh.fed_rules(None, mesh)._client_member(8)
    for arch in ("lm-100m", "granite-3-2b", ARCH):
        for shape in MESHES:
            jt = jsh.topology_for(jreg.get_config(arch), _FakeMesh(**shape))
            tt = sharding.topology_for(treg.get_config(arch), _FakeMesh(**shape))
            assert (tt.num_edges, tt.clients_per_edge, tt.num_clients) == (
                jt.num_edges, jt.clients_per_edge, jt.num_clients)
    ragged = dataclasses.replace(treg.get_config("lm-100m"), fed=dataclasses.replace(
        treg.get_config("lm-100m").fed, fanouts=((3, 2), (2,)), kappas=(2, 2)))
    jragged = dataclasses.replace(jreg.get_config("lm-100m"), fed=dataclasses.replace(
        jreg.get_config("lm-100m").fed, fanouts=((3, 2), (2,)), kappas=(2, 2)))
    assert sharding.topology_for(ragged, _FakeMesh(data=2)).num_clients == jsh.topology_for(
        jragged, _FakeMesh(data=2)).num_clients == 5


def test_a_spec_slices_this_ranks_block():
    class _Rank(_FakeMesh):
        def axis_index(self, name):
            return {"pod": 1, "data": 2, "model": 0}[name]

    mesh = _Rank(pod=2, data=4, model=1)
    x = torch.arange(16 * 3).reshape(16, 3)
    assert torch.equal(sharding.P(("pod", "data"), None).shard(x, mesh), x[12:14])
    assert torch.equal(sharding.P("data", None).shard(x, mesh), x[8:12])
    assert torch.equal(sharding.P(None, "model").shard(x, mesh), x)
    assert sharding.P("data", None) == ("data", None) and sharding.P() == ()


def test_hint_mesh_table_and_the_model_axis_refusal():
    x = torch.ones(4, 6)
    assert sharding.hint(x, "data", None) is x
    assert sharding.hint_mesh() is None and sharding.hint_data_groups() == 1 and sharding.moe_ep_mode(8) == "none"
    for shape, experts in ((dict(data=2, model=1), 8), (dict(data=4), 6), (dict(data=1, model=1), 8),
                           (dict(pod=2, model=1), 8), (dict(data=4, model=1), 8)):
        mesh = _FakeMesh(**shape)
        jsh.set_hint_mesh(mesh)
        try:
            want = (jsh.hint_data_groups(), jsh.moe_ep_mode(experts))
        finally:
            jsh.set_hint_mesh(None)
        with sharding.using_hint_mesh(mesh):
            assert (sharding.hint_data_groups(), sharding.moe_ep_mode(experts)) == want, shape
        assert sharding.hint_mesh() is None
    # a "model" axis larger than 1 is installed; every family passes on
    # it, the MoE ones among them (item 16b)
    mesh = _FakeMesh(data=2, model=2)
    with sharding.using_hint_mesh(mesh):
        assert sharding.hint_model_mesh() is mesh and sharding.model_kv_heads(4) == 2
    assert sharding.hint_mesh() is None
    sharding.refuse_model_axis(mesh, treg.get_smoke(ARCH))
    sharding.refuse_model_axis(mesh, treg.get_smoke("deepseek-7b"))


# ---------------------------------------------------------------------------
# moe_apply: one process at G = 2, and two expert-parallel ranks
# ---------------------------------------------------------------------------


def _jax_moe_main(out_path):
    """JAX's ``moe_apply`` on the smoke MoE off-mesh and under (2,) and
    (2, 2) host hint meshes (run with four host devices)."""
    from repro.launch.mesh import make_host_mesh
    from repro.models import layers as jl

    cfg = jreg.get_smoke(ARCH)
    params = jl.init_moe(jax.random.PRNGKey(3), cfg)
    x = np.random.default_rng(0).normal(size=(T, cfg.d_model)).astype(np.float32)
    out = {"params": jax.device_get(params), "x": x}
    for name, mesh in (("g1", None), ("data2", make_host_mesh((2,), ("data",))),
                       ("data2_model2", make_host_mesh((2, 2), ("data", "model")))):
        jsh.set_hint_mesh(mesh)
        try:
            if mesh is not None:
                assert jsh.moe_ep_mode(cfg.moe.num_experts) == "ep_data"
            y, aux = jax.jit(lambda p, v: jl.moe_apply(p, v, cfg))(params, x)
        finally:
            jsh.set_hint_mesh(None)
        out[name] = (np.asarray(y), float(aux))
    pickle.dump(out, open(out_path, "wb"))


@pytest.fixture(scope="module")
def moe_runs(tmp_path_factory):
    """JAX's runs from a four-device subprocess; the port's 2-rank runs (and
    the swapped-experts control) from two spawned gloo worlds."""
    d = tmp_path_factory.mktemp("moe")
    env = {**os.environ, "XLA_FLAGS": "--xla_force_host_platform_device_count=4", "JAX_PLATFORMS": "cpu",
           "PYTHONPATH": os.path.join(ROOT, "src")}
    code = ("import sys; sys.path.insert(0, sys.argv[2]); import test_torch_model_parallel as t; "
            "t._jax_moe_main(sys.argv[1])")
    subprocess.run([sys.executable, "-c", code, str(d / "jax.pkl"), os.path.join(ROOT, "tests")], env=env,
                   cwd=ROOT, check=True, timeout=600)
    ref = pickle.load(open(d / "jax.pkl", "rb"))
    moe = {k: np.asarray(v) for k, v in ref["params"].items() if k != "shared"}
    moe["shared"] = {k: np.asarray(v) for k, v in ref["params"]["shared"].items()}
    ep = launch.spawn(ranks.moe_ep, 2, "gloo", (ARCH, moe, ref["x"]))
    swapped = launch.spawn(ranks.moe_ep, 2, "gloo", (ARCH, moe, ref["x"], True))
    return ref, moe, ep, swapped


def _port_moe(moe):
    out = {k: torch.as_tensor(v) for k, v in moe.items() if k != "shared"}
    out["shared"] = {k: torch.as_tensor(v) for k, v in moe["shared"].items()}
    return out


def test_moe_at_two_groups_in_one_process_tracks_jax(moe_runs):
    ref, moe, _, _ = moe_runs
    cfg = treg.get_smoke(ARCH)
    with sharding.using_hint_mesh(_FakeMesh(data=2)):  # every expert on this rank: both groups here
        y, aux = tlayers.moe_apply(_port_moe(moe), torch.as_tensor(ref["x"]), cfg)
    for name in ("data2", "data2_model2"):
        _layer_close(y.numpy(), ref[name][0], err_msg=name)
        np.testing.assert_allclose(float(aux), ref[name][1], rtol=1e-5, atol=1e-6)
    y1, aux1 = tlayers.moe_apply(_port_moe(moe), torch.as_tensor(ref["x"]), cfg)
    _layer_close(y1.numpy(), ref["g1"][0], err_msg="G = 1")
    np.testing.assert_allclose(float(aux1), ref["g1"][1], rtol=1e-5, atol=1e-6)


def test_moe_over_two_expert_parallel_ranks_tracks_jax(moe_runs):
    ref, _, ep, _ = moe_runs
    y = np.concatenate([r["y"] for r in ep])
    for name in ("data2", "data2_model2"):
        _layer_close(y, ref[name][0], err_msg=name)
        for r in ep:
            np.testing.assert_allclose(r["aux"], ref[name][1], rtol=1e-5, atol=1e-6)
    for r in ep:  # one dispatch and one combine exchange, one all-reduce of the router statistics
        assert r["counts"]["all_to_all"] == 2 and r["counts"]["moe_aux_all_reduce"] == 1
        assert r["counts"]["all_reduce"] == 0


def test_swapping_two_ranks_expert_slices_fails(moe_runs):
    ref, _, _, swapped = moe_runs
    y = np.concatenate([r["y"] for r in swapped])
    with pytest.raises(AssertionError):
        _layer_close(y, ref["data2"][0])
