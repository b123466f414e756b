"""Event-driven energy/footprint model (paper Fig. 4 / Table 2 analogue).

The port's copy of the JAX package's ``repro.core.energy`` (pure
Python): the same constants, counts and formulas, so both packages give
equal results field for field.  Every number here models a 100 MHz FPGA;
none is a time, power or energy of the GPU the port runs on.

The paper measures FPGA wall-power of Wenquxing 22A (5.055 W) vs ODIN
driven by the same NutShell control core (25.949 W) — a 5.13x gap it
attributes to the decoupled CPU<->accelerator control/data flow.  We
cannot measure watts in this container, so this module implements the
standard event-driven accounting (the same kind the 12.7 pJ/SOP ODIN
figure comes from) for two machine models:

* ``fused``     — Wenquxing-style: the SNNU lives in the pipeline; per
  cycle each neuron row is streamed once past the SPU/NU/SU, weights are
  written back only on post-spikes, no event queue, no bus transfers.
* ``decoupled`` — ODIN-style accelerator behind a bus: per *input spike
  event* an AER packet crosses the bus, the full synapse column is read,
  all neuron states are read+written, and the controller core polls.

Constants are explicit and documented; results are **modeled energy**,
clearly labeled as such everywhere they are reported.

Model validity: the fused machine streams every synapse row every cycle
while the decoupled machine is event-driven, so the fused advantage
holds for input activity >= ~5% per cycle (Poisson-encoded MNIST runs
at 15-20%); at near-zero activity the event-driven accelerator's
idle-cycle skipping wins (property-tested crossover,
tests/test_property.py, tests/test_torch_energy.py).
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class EnergyConstants:
    """Per-event energies (J) and static power (W).

    e_sop:    energy per synaptic operation (AND+count lane) — ODIN's
              measured 12.7 pJ/SOP [Frenkel 2019] is the reference point.
    e_sram:   per-byte SRAM access.
    e_bus:    per-byte bus/AER transfer (decoupled model only).
    e_nu:     per neuron-state update.
    p_static: static/idle power of the compute fabric.
    """
    e_sop: float = 12.7e-12
    e_sram: float = 5.0e-12
    e_bus: float = 40.0e-12
    e_nu: float = 20.0e-12
    p_static_fused: float = 0.35      # SNNU shares the CPU pipeline
    p_static_decoupled: float = 1.75  # separate accelerator + bus + poll
    cycle_s: float = 1.0 / 100e6      # 100 MHz FPGA clock


@dataclass
class EventCounts:
    """Raw activity counters for one presentation window."""
    cycles: int = 0
    input_spikes: int = 0      # total pre-synaptic spike events
    sops: int = 0              # synaptic AND+count lane ops
    neuron_updates: int = 0
    post_spikes: int = 0       # STDP row-update events
    weight_bytes: int = 0      # synapse memory traffic
    state_bytes: int = 0       # membrane/LFSR traffic
    bus_bytes: int = 0         # decoupled only


def count_events(n_neurons: int, n_inputs: int, n_steps: int,
                 input_spike_total: int, post_spike_total: int,
                 machine: str) -> EventCounts:
    """Analytic event counts for one sample presentation.

    input_spike_total: sum over cycles of active inputs (from the raster).
    post_spike_total:  sum over cycles of fired neurons.
    """
    words = (n_inputs + 31) // 32
    row_bytes = words * 4
    c = EventCounts(cycles=n_steps, input_spikes=input_spike_total,
                    post_spikes=post_spike_total)
    if machine == "fused":
        # One streaming pass per cycle: every row read once; written back
        # only on post spikes.  Neuron state lives in registers (no SRAM).
        c.sops = input_spike_total * n_neurons
        c.neuron_updates = n_steps * n_neurons
        c.weight_bytes = n_steps * n_neurons * row_bytes \
            + post_spike_total * row_bytes
        c.state_bytes = 0
        c.bus_bytes = 0
    elif machine == "decoupled":
        # Per input-spike event: AER packet (4B each way), synapse column
        # read (n_neurons bits), all neuron states read+written (4B each),
        # plus weight write-back traffic on post spikes and per-cycle
        # controller polling (8B MMIO).
        col_bytes = (n_neurons + 7) // 8
        c.sops = input_spike_total * n_neurons
        c.neuron_updates = input_spike_total * n_neurons
        c.weight_bytes = input_spike_total * col_bytes \
            + post_spike_total * row_bytes * 2
        c.state_bytes = input_spike_total * n_neurons * 8
        c.bus_bytes = input_spike_total * 8 + n_steps * 8
    else:
        raise ValueError(f"unknown machine model {machine!r}")
    return c


def energy(c: EventCounts, k: EnergyConstants, machine: str) -> dict:
    """Modeled energy breakdown (J) and average power (W) for the window."""
    t = c.cycles * k.cycle_s
    dyn = (c.sops * k.e_sop
           + c.neuron_updates * k.e_nu
           + (c.weight_bytes + c.state_bytes) * k.e_sram
           + c.bus_bytes * k.e_bus)
    p_static = k.p_static_fused if machine == "fused" else k.p_static_decoupled
    stat = p_static * t
    return {
        "dynamic_J": dyn,
        "static_J": stat,
        "total_J": dyn + stat,
        "avg_power_W": (dyn + stat) / t if t else 0.0,
        "time_s": t,
    }


def footprint(n_neurons: int, n_inputs: int) -> dict:
    """Table-2 analogue: storage footprint of the SNN state (bytes).

    FPGA LUT/FF/BRAM cannot be synthesized here; the architectural
    quantity that drives them is the state the SNNU must hold.
    """
    words = (n_inputs + 31) // 32
    return {
        "synapse_bytes": n_neurons * words * 4,
        "membrane_bytes": n_neurons * 4,
        "lfsr_bytes": n_neurons * words * 4,
        "spike_reg_bytes": words * 4,
    }
