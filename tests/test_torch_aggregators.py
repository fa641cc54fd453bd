"""The port's robust aggregators (coordinate-wise trimmed mean and median,
the per-level ``AggregatorSpec``) against the JAX package's, on the same
numpy inputs: the statistics on uniform, ragged and depth-3 trees with and
without survival masks, the grammar and its errors, the robust branch of
the level sync inside whole cloud intervals, and the eval model.

Tolerance: f32 ``atol=1e-6`` (values ~N(0, 1)): both sort the same values
and sum the kept ones in f32, in another order. Zero-survivor groups are
held bit for bit.
"""
import math
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import aggregation as jagg
from repro.core import hierfavg as jh
from repro.core.hierarchy import parse_fanouts as jparse
from repro.fed import api as japi
from repro_torch.core import aggregation as tagg
from repro_torch.core import hierfavg as th
from repro_torch.core.hierarchy import parse_fanouts as tparse
from repro_torch.fed import api as tapi
from repro_torch.fed import scenarios as tscen
from repro_torch.testing.parity import assert_close, to_numpy

ROBUST = dict(rtol=0.0, atol=1e-6)
TREES = {"uniform": "5,5,5,5/4", "ragged": "16,12,10,7,5/5", "depth3": "10,10,10,10,10/3,2/2"}
STATS = {
    "trimmed_0.1": (lambda t, ids, g, m: jagg.segment_trimmed_mean(t, ids, g, m, trim=0.1),
                    lambda t, ids, g, m: tagg.segment_trimmed_mean(t, ids, g, m, trim=0.1)),
    "trimmed_0.25": (lambda t, ids, g, m: jagg.segment_trimmed_mean(t, ids, g, m, trim=0.25),
                     lambda t, ids, g, m: tagg.segment_trimmed_mean(t, ids, g, m, trim=0.25)),
    "median": (jagg.segment_coordinate_median, tagg.segment_coordinate_median),
}


def _tree(rng, n):
    return {"w": rng.normal(size=(n, 3, 4)).astype(np.float32), "b": rng.normal(size=(n, 7)).astype(np.float32),
            "s": rng.normal(size=(n,)).astype(np.float32)}


def _mask(rng, spec, kind):
    if kind == "none":
        return None
    m = (rng.random(spec.num_clients) > 0.3).astype(np.float32)
    if kind == "dead_group":
        m[spec.segments(1) == 0] = 0.0  # every member of edge 0 dead
    return m


@pytest.mark.parametrize("tree", sorted(TREES))
@pytest.mark.parametrize("mask_kind", ["none", "random", "dead_group"])
@pytest.mark.parametrize("stat", sorted(STATS))
def test_robust_statistics_match_jax_at_every_level(tree, mask_kind, stat):
    rng = np.random.default_rng(zlib.crc32(f"{tree}/{mask_kind}/{stat}".encode()))
    jspec, tspec = jparse(TREES[tree]), tparse(TREES[tree])
    x = _tree(rng, jspec.num_clients)
    mask = _mask(rng, jspec, mask_kind)
    jfn, tfn = STATS[stat]
    for level in range(1, jspec.depth + 1):
        ids, g = jspec.segments(level), jspec.num_nodes(level)
        want = jfn({k: jnp.asarray(v) for k, v in x.items()}, ids, g, None if mask is None else jnp.asarray(mask))
        got = tfn({k: torch.from_numpy(v) for k, v in x.items()}, tspec.segments(level), g,
                  None if mask is None else torch.from_numpy(mask))
        assert_close(to_numpy(got), jax.device_get(want), what=f"{stat} {tree} level {level} {mask_kind}", **ROBUST)
        if mask_kind == "dead_group" and level == 1:
            dead = torch.from_numpy(tspec.segments(1) == 0)
            for k in x:  # no survivors: the members keep their rows, bit for bit
                assert torch.equal(got[k][dead], torch.from_numpy(x[k])[dead])


def test_trimmed_mean_over_five_survivors_is_the_member_mean():
    """floor(0.1 * 5) = 0: nothing is trimmed, so the statistic is the
    unweighted mean of the members (summed in sorted order: f32 rounding)."""
    rng = np.random.default_rng(3)
    x = rng.normal(size=(5, 64)).astype(np.float32)
    got = tagg.segment_trimmed_mean({"x": torch.from_numpy(x)}, np.zeros(5, np.int32), 1, trim=0.1)["x"]
    np.testing.assert_allclose(got.numpy(), np.broadcast_to(x.mean(0), x.shape), rtol=0, atol=1e-6)


@pytest.mark.parametrize("clients_per_edge,trims", [(5, False), (8, False), (10, True)])
def test_trimmed_edge_trims_only_from_ten_survivors(clients_per_edge, trims):
    """``trimmed_edge`` (4 x 5 clients, trim 0.1) never trims, as in the
    reference: floor(0.1 * m) = 0 for m <= 9; 8-client edges neither. With
    10 survivors one value is dropped at each end, so an outlier no longer
    reaches the mean."""
    spec = tscen.get("trimmed_edge", overrides=[f"topology.clients_per_edge={clients_per_edge}"])
    agg = spec.hier_config().aggregators.aggregator(1)
    assert agg.name == "trimmed_mean:0.1" and math.floor(0.1 * clients_per_edge) == int(trims)
    x = torch.zeros(clients_per_edge, 4)
    x[0] = 1e3
    got = agg.segment_call({"x": x}, np.zeros(clients_per_edge, np.int32), 1)["x"]
    want = 0.0 if trims else 1e3 / clients_per_edge
    assert torch.allclose(got, torch.full_like(x, want))


def test_an_outlier_moves_the_weighted_mean_but_not_the_robust_statistics():
    """One client's rows + 1e3 before an edge sync (8 clients, weights 1..8):
    the weighted mean of its edge moves by at least 1e3 * w_i / sum(w),
    the trimmed mean at 0.25 (two dropped at each end) and the median stay
    within the range of the other members."""
    rng = np.random.default_rng(0)
    spec = tparse("8,8/2")
    x = torch.from_numpy(rng.normal(size=(16, 32)).astype(np.float32))
    w = torch.arange(1, 17, dtype=torch.float32)
    bad = x.clone()
    bad[3] += 1e3
    base = tagg.hierarchical_segment_mean({"x": x}, w, spec, 1)["x"]
    moved = tagg.hierarchical_segment_mean({"x": bad}, w, spec, 1)["x"]
    assert float((moved[0] - base[0]).min()) >= 1e3 * float(w[3] / w[:8].sum()) * (1 - 1e-5)
    others = torch.cat([x[:3], x[4:8]])
    for agg in (tagg.TrimmedMeanAggregator(0.25), tagg.CoordinateMedianAggregator()):
        out = agg({"x": bad}, w, spec, 1)["x"][0]
        assert bool((out >= others.min(0).values).all() and (out <= others.max(0).values).all()), agg.name


@pytest.mark.parametrize("text", ["weighted_mean", "mean", "trimmed_mean", "trimmed_mean:0.2",
                                  "coordinate_median", "median", "trimmed_mean:0.1/weighted_mean",
                                  "weighted_mean/coordinate_median", "median/trimmed_mean:0.3/mean"])
def test_grammar_and_describe_match_jax(text):
    j, t = jagg.AggregatorSpec.parse(text), tagg.AggregatorSpec.parse(text)
    assert t.describe() == j.describe()
    assert (t.depth, t.is_trivial) == (j.depth, j.is_trivial)
    assert [type(a).__name__ for a in t.aggregators] == [type(a).__name__ for a in j.aggregators]
    assert [a.is_default for a in t.aggregators] == [a.is_default for a in j.aggregators]


@pytest.mark.parametrize("call", [
    lambda m: m.parse_aggregator("trimmed"),
    lambda m: m.parse_aggregator("trimmed_mean:0.5"),
    lambda m: m.TrimmedMeanAggregator(-0.1),
    lambda m: m.AggregatorSpec.parse("/"),
    lambda m: m.AggregatorSpec(aggregators=()),
    lambda m: m.AggregatorSpec.parse("median").aggregator(2),
    lambda m: m.segment_trimmed_mean({}, [0], 1, trim=0.5),
])
def test_errors_match_jax_word_for_word(call):
    with pytest.raises(ValueError) as jerr:
        call(jagg)
    with pytest.raises(ValueError) as terr:
        call(tagg)
    assert str(terr.value) == str(jerr.value)


@pytest.mark.parametrize("kwargs", [
    dict(kappas=(2, 2), aggregators="median/median/median"),
    dict(kappas=(2, 2), aggregators="weighted_mean/median", delta_cloud=True),
    dict(kappas=(2, 2, 2), aggregators="median/mean"),
])
def test_config_value_errors_match_jax(kwargs):
    kw = dict(kwargs)
    kappas, text = kw.pop("kappas"), kw.pop("aggregators")
    with pytest.raises(ValueError) as jerr:
        jh.HierFAVGConfig.multi_level(kappas, aggregators=jagg.AggregatorSpec.parse(text), **kw)
    with pytest.raises(ValueError) as terr:
        th.HierFAVGConfig.multi_level(kappas, aggregators=tagg.AggregatorSpec.parse(text), **kw)
    assert str(terr.value) == str(jerr.value)
    with pytest.raises(TypeError, match="AggregatorSpec"):
        th.HierFAVGConfig(kappa1=2, kappa2=2, aggregators="median")


@pytest.mark.parametrize("levels", ["weighted_mean", "median", "trimmed_mean:0.1/weighted_mean",
                                    "weighted_mean/coordinate_median", "median/median/median", "bogus"])
def test_spec_section_builds_like_jax(levels):
    jspec, tspec = (m.ExperimentSpec.parse([f"aggregators.levels={levels}"]) for m in (japi, tapi))
    try:
        want = jspec.hier_config().aggregators
    except ValueError as e:
        with pytest.raises(ValueError) as terr:
            tspec.hier_config()
        assert str(terr.value) == str(e)
        return
    got = tspec.hier_config().aggregators
    assert (got is None) == (want is None)
    if want is not None:
        assert got.describe() == want.describe()
    assert tspec.hier_config().aggregators_active == jspec.hier_config().aggregators_active


def test_megakernel_refuses_robust_aggregators_in_jax_words():
    spec = tparse("4,4/2")
    cfg = th.HierFAVGConfig(kappa1=2, kappa2=2, aggregators=tagg.AggregatorSpec.parse("median/mean"))
    jcfg = jh.HierFAVGConfig(kappa1=2, kappa2=2, aggregators=jagg.AggregatorSpec.parse("median/mean"))
    reason = th.megakernel_incompatibility(cfg, spec)
    assert reason == jh.megakernel_incompatibility(jcfg, jparse("4,4/2"))
    assert reason == "non-default aggregators need the full client axis at each sync"
    trivial = th.HierFAVGConfig(kappa1=2, kappa2=2, aggregators=tagg.AggregatorSpec.parse("mean/mean"))
    assert th.megakernel_incompatibility(trivial, spec) is None


# -- the level sync inside whole cloud intervals ----------------------------------


DIM, HIDDEN, CLASSES, BATCH = 6, 8, 4, 3
MODEL = [f"data.dim={DIM}", f"model.hidden={HIDDEN}", f"data.num_classes={CLASSES}"]


def _batch(rng, lead):
    return {"inputs": rng.normal(size=lead + (BATCH, DIM)).astype(np.float32),
            "targets": rng.integers(0, CLASSES, size=lead + (BATCH,)).astype(np.int32)}


@pytest.mark.parametrize("tree,kappas,levels", [
    ("5,5,5,5/4", (2, 3), "trimmed_mean:0.2/weighted_mean"),
    ("5,5,5,5/4", (2, 3), "weighted_mean/coordinate_median"),
    ("16,12,10,7,5/5", (1, 2), "median/trimmed_mean:0.25"),
    ("10,10,10,10,10/3,2/2", (1, 2, 2), "trimmed_mean:0.1/median/weighted_mean"),
])
@pytest.mark.parametrize("masked", [False, True], ids=["all_alive", "masked"])
def test_robust_cloud_intervals_match_jax(tree, kappas, levels, masked):
    from repro import optim as joptim
    from repro_torch import optim as toptim

    jspec_e, tspec_e = japi.ExperimentSpec.parse(MODEL), tapi.ExperimentSpec.parse(MODEL)
    np_params = jax.device_get(jspec_e.init_params(jax.random.PRNGKey(1)))
    jb, tb = japi._model_bundle(jspec_e), tspec_e.model_bundle("cpu")
    jopt, topt = joptim.sgd(0.15), toptim.sgd(0.15)
    jspec, tspec = jparse(tree), tparse(tree)
    jcfg = jh.HierFAVGConfig.multi_level(kappas, aggregators=jagg.AggregatorSpec.parse(levels))
    tcfg = th.HierFAVGConfig.multi_level(kappas, aggregators=tagg.AggregatorSpec.parse(levels))
    js = jh.init_state(jax.random.PRNGKey(0), jax.tree_util.tree_map(jnp.asarray, np_params), jopt, jspec, jcfg)
    ts = th.init_state(torch.Generator().manual_seed(0), tspec_e.params_from_numpy(np_params, "cpu"), topt,
                       tspec, tcfg)
    rng = np.random.default_rng(len(tree) + sum(kappas))
    n = jspec.num_clients
    w = rng.integers(20, 80, n).astype(np.float32)
    jsuper = jax.jit(jh.build_super_round(jb["loss"], jopt, jspec, jcfg, jnp.asarray(w)))
    tsuper = th.build_super_round(tb["loss"], topt, tspec, tcfg, torch.from_numpy(w))
    k2 = jcfg.kappa2_effective
    for _ in range(2):
        block = _batch(rng, (k2, jcfg.kappa1, n))
        masks = None
        if masked:
            masks = (rng.random((k2, n)) > 0.25).astype(np.float32)
            masks[0, tspec.segments(1) == 0] = 0.0  # edge 0 dead in the first round
        js, jm = jsuper(js, {k: jnp.asarray(v) for k, v in block.items()}, None if masks is None else jnp.asarray(masks))
        ts, tm = tsuper(ts, {k: torch.from_numpy(v) for k, v in block.items()},
                        None if masks is None else torch.from_numpy(masks))
        assert_close(to_numpy(tm), jax.device_get(jm), rtol=1e-5, atol=1e-6, what=f"metrics {levels}")
    assert_close(to_numpy(ts.params), jax.device_get(js.params), rtol=1e-5, atol=1e-6, what=f"params {levels}")


def test_all_default_spec_keeps_the_weighted_mean_path_bit_for_bit():
    tb = tapi.ExperimentSpec.parse(MODEL).model_bundle("cpu")
    params = tb["init"](0)
    spec = tparse("5,5,5,5/4")
    rng = np.random.default_rng(2)
    w = torch.from_numpy(rng.integers(20, 80, 20).astype(np.float32))
    block = {k: torch.from_numpy(v) for k, v in _batch(rng, (3, 2, 20)).items()}
    out = []
    from repro_torch import optim as toptim

    for aggs in (None, tagg.AggregatorSpec.parse("weighted_mean/mean")):
        cfg = th.HierFAVGConfig(kappa1=2, kappa2=3, aggregators=aggs)
        assert not cfg.aggregators_active
        s = th.init_state(torch.Generator().manual_seed(0), params, toptim.sgd(0.1), spec, cfg)
        out.append(th.build_super_round(tb["loss"], toptim.sgd(0.1), spec, cfg, w)(s, block)[0])
    for k in params:
        assert torch.equal(out[0].params[k], out[1].params[k])


@pytest.mark.parametrize("name,stat", [("median_cloud", "median"), ("trimmed_edge", None)])
def test_eval_model_scores_the_robust_top_statistic(name, stat):
    runner = tscen.get(name).build(device="cpu")
    rng = np.random.default_rng(7)
    n = runner.topology.num_clients
    x = {k: rng.normal(size=(n,) + tuple(v.shape[1:])).astype(np.float32)
         for k, v in runner.init(torch.Generator(), runner.spec.init_params(1, "cpu")).params.items()}
    mask = (rng.random(n) > 0.2).astype(np.float32)
    got = runner.eval_model({k: torch.from_numpy(v) for k, v in x.items()}, torch.from_numpy(mask))
    jx, jm = {k: jnp.asarray(v) for k, v in x.items()}, jnp.asarray(mask)
    if stat == "median":  # the cloud publishes the median of its survivors
        want = jax.tree_util.tree_map(lambda v: v[0], jagg.segment_coordinate_median(jx, np.zeros(n, np.int32), 1, jm))
    else:  # a weighted-mean top level keeps the weighted mean
        want = jagg.cloud_model(jx, jnp.asarray(runner.weights.numpy()), jm)
    assert_close(to_numpy(got), jax.device_get(want), what=f"{name} eval model", **ROBUST)
