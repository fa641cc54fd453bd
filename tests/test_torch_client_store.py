"""The port's ``ClientStateStore`` against the JAX package's: gather,
scatter, ``state`` and ``load`` bit for bit on the same numpy rows,
never-written rows zero; ``sticky_rows`` / ``replace_sticky_rows`` on port
``FedState``s under sgd, momentum, Adam and int8 with error feedback (the
cohort rows JAX picks, leaf for leaf); bfloat16 rows kept exactly; and the
laws of ``tests/test_client_store.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import hierfavg as jh
from repro.fed import client_store as jcs
from repro.fed import transport as jtransport
from repro import optim as joptim
from repro_torch.checkpoint import CheckpointManager
from repro_torch.core import hierfavg as th
from repro_torch.fed import client_store as tcs
from repro_torch.fed import transport as ttransport
from repro_torch import optim as toptim
from repro_torch.testing.parity import to_numpy

N, C = 20, 4


def _template():
    return {"mu": np.zeros((3, 2), np.float32), "nu": np.zeros((3,), np.float32)}


def _rows(rng, count):
    return {"mu": rng.normal(size=(count, 3, 2)).astype(np.float32),
            "nu": rng.normal(size=(count, 3)).astype(np.float32)}


def _equal(a, b):
    assert sorted(a) == sorted(b)
    for k in a:
        np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]))


def test_gather_scatter_state_load_equal_jax(rng):
    js, ts = jcs.ClientStateStore(N, _template()), tcs.ClientStateStore(N, _template())
    for ids in ([2, 7, 11, 19], [0, 7, 8, 9], [19, 3, 5, 1]):
        rows = _rows(rng, C)
        js.scatter(np.array(ids), rows)
        ts.scatter(np.array(ids), rows)
        probe = np.array([0, 2, 7, 10, 15, 19])
        _equal(ts.gather(probe), js.gather(probe))
        assert ts.num_touched == js.num_touched
    assert ts.nbytes == js.nbytes and ts.is_empty == js.is_empty
    jstate, tstate = js.state(), ts.state()
    for a, b in zip(tstate["leaves"], jstate["leaves"]):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(tstate["touched"], jstate["touched"])
    # JAX's state loads into the port's store and back
    fresh = tcs.ClientStateStore(N, _template())
    fresh.load({"leaves": [np.asarray(x) for x in jstate["leaves"]], "touched": jstate["touched"]})
    _equal(fresh.gather(np.arange(N)), js.gather(np.arange(N)))
    assert fresh.num_touched == js.num_touched


def test_never_sampled_rows_are_zero_and_reads_do_not_mark(rng):
    store = tcs.ClientStateStore(N, _template())
    store.scatter(np.array([0, 1, 2, 3]), _rows(rng, C))
    fresh = store.gather(np.array([10, 15]))
    for key in ("mu", "nu"):
        np.testing.assert_array_equal(fresh[key], np.zeros_like(fresh[key]))
    assert store.num_touched == C


def test_gather_into_fills_preallocated_buffers(rng):
    store = tcs.ClientStateStore(N, _template())
    ids = np.array([1, 5, 6, 18])
    rows = _rows(rng, C)
    store.scatter(ids, rows)
    out = [np.full((C, 3, 2), np.nan, np.float32), np.full((C, 3), np.nan, np.float32)]
    store.gather_into(ids, out)
    np.testing.assert_array_equal(out[0], rows["mu"])
    np.testing.assert_array_equal(out[1], rows["nu"])


def test_scatter_overwrites_and_validates_shapes(rng):
    store = tcs.ClientStateStore(N, _template())
    ids = np.array([1, 3, 5, 7])
    store.scatter(ids, _rows(rng, C))
    second = _rows(rng, C)
    store.scatter(ids, second)
    np.testing.assert_array_equal(store.gather(ids)["mu"], second["mu"])
    with pytest.raises(ValueError, match="row leaves"):
        store.scatter(np.array([0]), {"mu": np.zeros((1, 3, 2), np.float32)})
    with pytest.raises(ValueError, match="incompatible"):
        store.scatter(np.array([0]), {"mu": np.zeros((1, 3, 3), np.float32), "nu": np.zeros((1, 3), np.float32)})


def test_load_validates_like_jax():
    store = tcs.ClientStateStore(N, _template())
    bad = store.state()
    with pytest.raises(ValueError, match="store leaves"):
        store.load({"leaves": bad["leaves"][:1], "touched": bad["touched"]})
    with pytest.raises(ValueError, match="shape"):
        store.load({"leaves": [np.zeros((N + 1, 3, 2), np.float32), np.zeros((N, 3), np.float32)],
                    "touched": bad["touched"]})


def test_store_survives_a_checkpoint(rng, tmp_path):
    store = tcs.ClientStateStore(N, _template())
    ids = np.array([2, 5, 13, 17])
    rows = _rows(rng, C)
    store.scatter(ids, rows)
    CheckpointManager(str(tmp_path), keep=2).save(1, {"store": store.state()}, {"round": 2})
    back = tcs.ClientStateStore(N, _template())
    payload, meta = CheckpointManager(str(tmp_path)).restore_latest({"store": back.state()})
    back.load(payload["store"])
    assert meta["round"] == 2 and back.num_touched == C
    _equal(back.gather(ids), rows)


def test_nbytes_scales_with_population_and_pages_stay_lazy():
    small, big = tcs.ClientStateStore(10, _template()), tcs.ClientStateStore(1000, _template())
    assert big.nbytes > 90 * small.nbytes


def test_placement_swaps_name_item_12(rng):
    """The sharded cohort's swaps (ROADMAP item 12, ported): JAX's rows in
    slot placement order, a phantom slot dropped on the way back."""
    from repro.core.hierarchy import parse_fanouts as jparse, plan_cohort_placement as jplan
    from repro_torch.core.hierarchy import parse_fanouts as tparse, plan_cohort_placement as tplan

    quotas = (3, 1, 1)  # 5 slots over edges of 8, 6 and 6 clients, 2 ranks: 1 phantom
    jp, tp = jplan(jparse("8,6,6"), quotas, 2), tplan(tparse("8,6,6"), quotas, 2)
    assert tp.perm == jp.perm and tp.num_phantoms == 1
    ids = np.array([1, 2, 5, 9, 15])
    rows = _rows(rng, tp.padded_clients)
    js, ts = jcs.ClientStateStore(N, _template()), tcs.ClientStateStore(N, _template())
    js.scatter_placed(ids, jp, rows)
    ts.scatter_placed(ids, tp, rows)
    for a, b in zip(js.state()["leaves"], ts.state()["leaves"]):
        np.testing.assert_array_equal(np.asarray(a), b)
    np.testing.assert_array_equal(np.asarray(js.state()["touched"]), ts.state()["touched"])
    for k in ("mu", "nu"):
        np.testing.assert_array_equal(ts.gather_placed(ids, tp)[k], np.asarray(js.gather_placed(ids, jp)[k]))


# -- sticky rows of real cohort states ----------------------------------------------


def _cohort_states(kind):
    params = {"b": np.zeros((2,), np.float32), "w": np.arange(6, dtype=np.float32).reshape(3, 2)}
    if kind == "momentum":
        jopt, topt = joptim.momentum(0.1, 0.9), toptim.momentum(0.1, 0.9)
    elif kind == "adam":
        jopt, topt = joptim.adam(1e-3), toptim.adam(1e-3)
    else:
        jopt, topt = joptim.sgd(0.1), toptim.sgd(0.1)
    transport = "int8_ef:64/int8_ef:64" if kind == "int8_ef" else None
    jcfg = jh.HierFAVGConfig(kappa1=2, kappa2=2, transport=transport and jtransport.TransportSpec.parse(transport))
    tcfg = th.HierFAVGConfig(kappa1=2, kappa2=2, transport=transport and ttransport.TransportSpec.parse(transport))
    js = jh.init_cohort_state(jax.random.PRNGKey(0), jax.tree_util.tree_map(jnp.asarray, params), jopt, jcfg, C)
    ts = th.init_cohort_state(torch.Generator().manual_seed(0), {k: torch.from_numpy(v) for k, v in params.items()},
                              topt, tcfg, C)
    return js, ts


@pytest.mark.parametrize("kind,n_opt,res", [("sgd", 0, False), ("momentum", 2, False), ("adam", 4, False),
                                            ("int8_ef", 0, True)])
def test_sticky_rows_pick_jax_leaves_and_round_trip(kind, n_opt, res):
    js, ts = _cohort_states(kind)
    jrows, trows = jcs.sticky_rows(js, C), tcs.sticky_rows(ts, C)
    assert len(trows["opt"]) == len(jrows["opt"]) == n_opt and ("res" in trows) == ("res" in jrows) == res
    for a, b in zip(trows["opt"], jrows["opt"]):
        assert tuple(a.shape) == b.shape
    perturbed = {"opt": [x + 1.0 for x in trows["opt"]]}
    if res:
        perturbed["res"] = {k: v + 2.0 for k, v in trows["res"].items()}
    swapped = tcs.replace_sticky_rows(ts, perturbed, C)
    back = tcs.sticky_rows(swapped, C)
    for a, b in zip(back["opt"], perturbed["opt"]):
        assert torch.equal(a, b)
    if res:
        _equal(to_numpy(back["res"]), to_numpy(perturbed["res"]))
    assert int(swapped.step) == int(ts.step)
    # the store built from these rows holds JAX's leaves, zero-initialised
    jstore = jcs.ClientStateStore.from_rows(N, jax.device_get(jrows))
    tstore = tcs.ClientStateStore.from_rows(N, trows)
    assert tstore.is_empty == jstore.is_empty == (n_opt == 0 and not res)
    for a, b in zip(tstore.state()["leaves"], jstore.state()["leaves"]):
        assert a.shape == b.shape and a.dtype == b.dtype and not a.any()


def test_bfloat16_rows_round_trip_exactly(rng):
    rows = {"opt": [torch.from_numpy(rng.normal(size=(C, 3, 2)).astype(np.float32)).to(torch.bfloat16)]}
    store = tcs.ClientStateStore.from_rows(N, rows)
    ids = np.array([3, 4, 9, 12])
    store.scatter(ids, rows)
    got = torch.from_numpy(store.gather(ids)["opt"][0]).view(torch.bfloat16)
    assert torch.equal(got, rows["opt"][0])
    assert store.state()["leaves"][0].dtype == np.int16
