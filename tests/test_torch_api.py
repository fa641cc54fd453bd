"""The spec's ``network`` section: the port parses each distribution string
eagerly, as ``repro.sim.distributions.NetworkSpec`` does, so a spec the JAX
package refuses does not build in the port either."""
import dataclasses

import pytest

from repro.fed import api as japi
from repro.sim import distributions as jdist
from repro_torch.fed import api as tapi
from repro_torch.sim import distributions as tdist

BAD = ["lognormal", "lognormal:-1", "mixture:0.5@1", "mixture:0.5x2", "foo"]
GOOD = ["det", "det:2.5", "lognormal:0.3", "lognormal:0.3:2", "mixture:0.9@1,0.1@8"]
AXES = [f.name for f in dataclasses.fields(tdist.NetworkSpec) if f.type == "str" and f.name != "jitter_granularity"]


@pytest.mark.parametrize("text", BAD)
@pytest.mark.parametrize("axis", ["client_speed", "edge_backhaul", "link_jitter"])
def test_bad_distribution_is_refused_like_jax(text, axis):
    with pytest.raises(ValueError):
        jdist.NetworkSpec(**{axis: text})
    with pytest.raises(ValueError):
        tdist.NetworkSpec(**{axis: text})


@pytest.mark.parametrize("text", GOOD)
def test_good_distribution_is_accepted_like_jax(text):
    for axis in AXES:
        jdist.NetworkSpec(**{axis: text})
        tdist.NetworkSpec(**{axis: text})
    assert AXES == [f.name for f in dataclasses.fields(jdist.NetworkSpec)
                    if f.type == "str" and f.name != "jitter_granularity"]


@pytest.mark.parametrize("text", GOOD)
def test_parsed_distribution_matches_jax(text):
    j, t = jdist.parse_distribution(text), tdist.parse_distribution(text)
    assert (t.kind, t.is_deterministic) == (j.kind, j.is_deterministic)
    assert t.mean() == pytest.approx(j.mean(), rel=1e-15)


@pytest.mark.parametrize("text", BAD)
def test_bad_network_override_fails_in_both_spec_trees(text):
    override = [f"network.client_link={text}"]
    with pytest.raises(ValueError):
        japi.ExperimentSpec.parse(override)
    with pytest.raises(ValueError):
        tapi.ExperimentSpec.parse(override)
