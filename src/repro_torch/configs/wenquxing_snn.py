"""The paper's own configuration: Wenquxing 22A MNIST SNN (784-{10,20,40}).

Table 1's "this work" row: 784 inputs, 1-bit synapses, binary stochastic
STDP, rate-Poisson encoding, {10, 20, 40} LIF neurons.  Only the fields
that the engine plan and serving read are here; the training fields
come with the training slice.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

from repro_torch.core.bitpack import n_words


@dataclass(frozen=True)
class SNNTrainConfig:
    n_inputs: int = 784
    n_classes: int = 10
    n_neurons: int = 40          # total population (multiple of n_classes)
    n_steps: int = 72            # presentation window T (cycles/sample)
    threshold: int = 192         # streamlined-LIF firing threshold
    leak: int = 16               # per-cycle leak
    w_exp: int = 128             # paper meta-parameter {128, 256, 512}
    gain: int = 4                # homeostatic LTD slope
    ltp_prob: int = 16           # 10-bit stochastic-LTP prob (base block)
    ltp_prob_active: int = 1023  # faster LTP for active-learning blocks
    kernel_backend: str = "kernel"   # "kernel" | "ref"
    window_chunk: int | None = None  # window-length quantum (None = 8)
    encode: str = "host"             # "host" | "kernel" (in-kernel draw)
    encode_seed: int = 0             # counter base for the draw

    @property
    def n_blocks(self) -> int:
        if self.n_neurons % self.n_classes:
            raise ValueError(f"n_neurons={self.n_neurons} is not a "
                             f"multiple of n_classes={self.n_classes}")
        return self.n_neurons // self.n_classes

    @property
    def words(self) -> int:
        return n_words(self.n_inputs)


WENQUXING_22A = SNNTrainConfig(
    n_inputs=784,
    n_classes=10,
    n_neurons=40,      # paper's best CA (91.91% on MNIST) at 40
    n_steps=72,
    threshold=192,
    leak=16,
    w_exp=128,         # paper sweeps {128, 256, 512}
    gain=4,
    ltp_prob=16,
    ltp_prob_active=1023,
)

VARIANTS = {
    n: dataclasses.replace(WENQUXING_22A, n_neurons=n)
    for n in (10, 20, 40)
}
