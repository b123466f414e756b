"""Paper Table 2: hardware utilization (LUT/FF/BRAM) analogue.

The port's counterpart of ``benchmarks/table2_resources.py``, the same
rows.  FPGA synthesis is out of reach; the architectural quantity behind
those numbers is the state the SNN datapath must hold.  We report the
storage footprint of the Wenquxing SNNU configuration vs an ODIN-style
256-neuron crossbar for the same task, plus the paper's reported
utilization for context.  Nothing here runs on the card.
"""

from __future__ import annotations

from repro_torch.bench.common import emit
from repro_torch.configs.wenquxing_snn import WENQUXING_22A
from repro_torch.core.energy import footprint

PAPER = {
    "ODIN": {"LUT": 63411, "FF": 75362, "BRAM": 82.5},
    "Wenquxing22A": {"LUT": 56487, "FF": 69702, "BRAM": 73.0},
}

# ODIN: fixed 256-neuron, 64k-synapse crossbar with 3-bit weights +
# per-neuron state RAM (its architecture, independent of the task)
ODIN = {
    "synapse_bytes": 256 * 256 * 3 // 8 * 8,  # 64k synapses x 3 bit
    "membrane_bytes": 256 * 13,               # ODIN neuron state
    "lfsr_bytes": 4,
    "spike_reg_bytes": 256 // 8,
}


def run() -> dict:
    cfg = WENQUXING_22A
    ours = footprint(cfg.n_neurons, cfg.n_inputs)
    for name, fp in (("this-work", ours), ("odin-crossbar", ODIN)):
        total = sum(fp.values())
        emit(f"table2/{name}", None,
             f"state_bytes={total};" +
             ";".join(f"{k}={v}" for k, v in fp.items()))
    for name, row in PAPER.items():
        emit(f"table2/paper-{name}", None,
             ";".join(f"{k}={v}" for k, v in row.items()))
    return {"ours_bytes": sum(ours.values()),
            "odin_bytes": sum(ODIN.values()), "ours": ours}


if __name__ == "__main__":
    run()
