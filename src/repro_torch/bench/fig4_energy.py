"""Paper Figure 4: power comparison Wenquxing 22A vs ODIN.

The port's counterpart of ``benchmarks/fig4_energy.py``.  Paper: 5.055 W
vs 25.949 W on the same Alveo U250 (5.13x).  We run the event-driven
energy model (:mod:`repro_torch.core.energy`) on real spike statistics
from the network trained on the card: the set bits of the test windows
and the output spikes they drive, for the fused-pipeline machine and the
decoupled-accelerator machine.  Every energy, power and time in the
rows is the model's (a 100 MHz FPGA), never the card's.

The test windows are materialized with the counter encode
(``encode_from_counter_batch``, seeds from base 7) and counted through
``network.infer_batch``, the pre-packed serving kernel on a card.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.bench.common import (digits_dataset, emit, encode_test_set,
                                      train_timed)
from repro_torch.configs.wenquxing_snn import WENQUXING_22A_INTENSITY
from repro_torch.core import network
from repro_torch.core.bitpack import unpack
from repro_torch.core.encoder import encode_from_counter_batch
from repro_torch.core.energy import EnergyConstants, count_events, energy

PAPER_RATIO = 25.949 / 5.055  # 5.13x
TEST_SEED = 7


def run(dataset=None, *, n_train=1000, n_test=200, n_neurons=40,
        n_steps=WENQUXING_22A_INTENSITY.n_steps,
        epochs=WENQUXING_22A_INTENSITY.epochs, device="cuda",
        block_seeds=None) -> dict:
    tr, tr_lab, te, te_lab = (dataset if dataset is not None else
                              digits_dataset(n_train=n_train, n_test=n_test))
    cfg = dataclasses.replace(WENQUXING_22A_INTENSITY, n_neurons=n_neurons,
                              n_steps=n_steps, epochs=epochs)
    model, train_s = train_timed(cfg, tr, tr_lab, device=device,
                                 block_seeds=block_seeds)
    inten, seeds = encode_test_set(te, TEST_SEED, device)
    st = encode_from_counter_batch(seeds, inten, cfg.n_steps)
    # real spike statistics over the test presentations
    in_spikes = int(unpack(st.reshape(-1, st.shape[-1]), cfg.n_inputs)
                    .sum(dtype=torch.int64))
    counts = network.infer_batch(model.weights, st, cfg.lif())
    post = int(counts.sum(dtype=torch.int64))
    n_samples = st.shape[0]
    k = EnergyConstants()

    results, events = {}, {}
    for machine in ("fused", "decoupled"):
        ev = count_events(cfg.n_neurons, cfg.n_inputs,
                          cfg.n_steps * n_samples, in_spikes, post,
                          machine)
        e = energy(ev, k, machine)
        results[machine], events[machine] = e, ev
        emit(f"fig4/{machine}", None,
             f"modeled_E={e['total_J']:.3e}J;avg_P={e['avg_power_W']:.3f}W;"
             f"modeled_time_us={e['time_s'] * 1e6:.2f}")
    ratio = results["decoupled"]["total_J"] / results["fused"]["total_J"]
    emit("fig4/ratio-decoupled-over-fused", None,
         f"modeled={ratio:.2f}x;paper={PAPER_RATIO:.2f}x")
    return {"ratio": ratio, "energy": results, "events": events,
            "in_spikes": in_spikes, "post": post, "model": model,
            "train_s": train_s}


if __name__ == "__main__":
    run()
