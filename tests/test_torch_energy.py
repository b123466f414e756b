"""The port's energy/footprint model against the JAX package's.

``repro_torch.core.energy`` is a copy of ``repro.core.energy``: over
hypothesis-drawn activity, event counts and widths, both give equal
event counts, energy breakdowns and footprints, field for field (``==``
on floats: the same formulas in the same order)."""

import dataclasses

import pytest
from hypothesis import given, settings, strategies as st

from repro.core import energy as jenergy
from repro_torch.core import energy

SET = settings(max_examples=60, deadline=None)
MACHINES = ("fused", "decoupled")


def test_constants_equal_the_jax_module():
    assert (dataclasses.asdict(energy.EnergyConstants())
            == dataclasses.asdict(jenergy.EnergyConstants()))
    assert ([f.name for f in dataclasses.fields(energy.EventCounts)]
            == [f.name for f in dataclasses.fields(jenergy.EventCounts)])


@SET
@given(st.integers(1, 10_000), st.integers(0, 2_000_000),
       st.integers(0, 100_000), st.integers(1, 70_000),
       st.integers(1, 2_000), st.sampled_from(MACHINES))
def test_count_events_and_energy_equal_the_jax_module(
        n_steps, input_spikes, post, n_in, n_n, machine):
    got = energy.count_events(n_n, n_in, n_steps, input_spikes, post,
                              machine)
    want = jenergy.count_events(n_n, n_in, n_steps, input_spikes, post,
                                machine)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert (energy.energy(got, energy.EnergyConstants(), machine)
            == jenergy.energy(want, jenergy.EnergyConstants(), machine))


@SET
@given(st.integers(0, 5_000), st.integers(1, 70_000))
def test_footprint_equals_the_jax_module(n_n, n_in):
    assert energy.footprint(n_n, n_in) == jenergy.footprint(n_n, n_in)


def test_energy_of_an_empty_window_has_no_power():
    c = energy.count_events(40, 784, 0, 0, 0, "fused")
    e = energy.energy(c, energy.EnergyConstants(), "fused")
    assert e == jenergy.energy(
        jenergy.count_events(40, 784, 0, 0, 0, "fused"),
        jenergy.EnergyConstants(), "fused")
    assert e["avg_power_W"] == 0.0 and e["total_J"] == 0.0


@SET
@given(st.floats(0.05, 1.0), st.integers(0, 10_000),
       st.integers(16, 1024), st.integers(8, 64))
def test_energy_fused_never_exceeds_decoupled(activity, post, n_in, n_n):
    """The port's mirror of ``tests/test_property.py``'s property: it
    holds for input activity >= 5% (below it the event-driven machine's
    idle-cycle skipping wins)."""
    k = energy.EnergyConstants()
    steps = 100
    in_spikes = int(activity * steps * n_in)
    ef = energy.energy(energy.count_events(n_n, n_in, steps, in_spikes,
                                           post, "fused"), k, "fused")
    ed = energy.energy(energy.count_events(n_n, n_in, steps, in_spikes,
                                           post, "decoupled"), k,
                       "decoupled")
    assert ef["total_J"] <= ed["total_J"]


@pytest.mark.parametrize("machine", ["odin", "", "Fused"])
def test_unknown_machine_raises(machine):
    with pytest.raises(ValueError, match="unknown machine model"):
        energy.count_events(40, 784, 72, 100, 5, machine)
    with pytest.raises(ValueError, match="unknown machine model"):
        jenergy.count_events(40, 784, 72, 100, 5, machine)
