"""The paper's own configuration: Wenquxing 22A MNIST SNN (784-{10,20,40}).

Table 1's "this work" row: 784 inputs, 1-bit synapses, binary stochastic
STDP, rate-Poisson encoding, {10, 20, 40} LIF neurons.  The config class
is :class:`~repro_torch.core.trainer.SNNTrainConfig`, re-exported here.
"""

from __future__ import annotations

import dataclasses

from repro_torch.core.trainer import SNNTrainConfig

__all__ = ["SNNTrainConfig", "VARIANTS", "WENQUXING_22A",
           "WENQUXING_22A_INTENSITY"]

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
    teach_pos=64,
    teach_neg=-1024,
    epochs=2,
)

VARIANTS = {
    n: dataclasses.replace(WENQUXING_22A, n_neurons=n)
    for n in (10, 20, 40)
}

# Intensity-resident ingestion: the dataset stays uint8[N, 784] and the
# window kernels draw each cycle's spikes from per-sample counter-hash
# seeds, so no N x T x w spike tensor exists.
WENQUXING_22A_INTENSITY = dataclasses.replace(
    WENQUXING_22A, encode="kernel", encode_seed=0x22A)
