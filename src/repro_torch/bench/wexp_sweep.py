"""Paper §3.3: the w_exp meta-parameter sweep {128, 256, 512}.

The port's counterpart of ``benchmarks/wexp_sweep.py``.  Validates the
dead-neuron claim: w_exp controls the LTD probability and thereby the
number of effective synapses; the wrong setting leaves neurons dead
(never winning for their class) and costs accuracy.  Each population is
trained on the card; the test windows are materialized with the counter
encode (seeds from base 99) and counted through ``network.infer_batch``,
the pre-packed serving kernel on a card.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np

from repro_torch.bench.common import (digits_dataset, emit, encode_test_set,
                                      train_timed)
from repro_torch.configs.wenquxing_snn import WENQUXING_22A_INTENSITY
from repro_torch.core import network
from repro_torch.core.bitpack import unpack
from repro_torch.core.encoder import encode_from_counter_batch

TEST_SEED = 99


def run(dataset=None, *, n_train=2000, n_test=1000, n_neurons=40,
        w_exps=(128, 256, 512), n_steps=WENQUXING_22A_INTENSITY.n_steps,
        epochs=WENQUXING_22A_INTENSITY.epochs, device="cuda",
        block_seeds=None) -> dict:
    tr, tr_lab, te, te_lab = (dataset if dataset is not None else
                              digits_dataset(n_train=n_train, n_test=n_test))
    inten, seeds = encode_test_set(te, TEST_SEED, device)
    st = encode_from_counter_batch(seeds, inten, n_steps)
    out = {}
    for wexp in w_exps:
        cfg = dataclasses.replace(WENQUXING_22A_INTENSITY, w_exp=wexp,
                                  n_neurons=n_neurons, n_steps=n_steps,
                                  epochs=epochs)
        t0 = time.perf_counter()
        model, train_s = train_timed(cfg, tr, tr_lab, device=device,
                                     block_seeds=block_seeds)
        counts = network.infer_batch(model.weights, st, cfg.lif())
        # ties go to the first neuron, as in the JAX package
        winner = counts.argmax(1)
        pred = model.neuron_class[winner].cpu().numpy()
        correct = int((pred == te_lab).sum())
        acc = correct / len(te_lab)
        # dead neuron = never the argmax winner on the test set
        winners = set(winner.tolist())
        dead = cfg.n_neurons - len(winners)
        on_bits = unpack(model.weights, cfg.n_inputs).sum(dim=1)
        mean_on = float(np.mean(on_bits.cpu().numpy()))
        emit(f"wexp/{wexp}", (time.perf_counter() - t0) * 1e6,
             f"CA={acc:.4f};dead={dead};mean_on={mean_on:.0f}")
        out[wexp] = {"acc": acc, "correct": correct, "dead": dead,
                     "mean_on": mean_on, "model": model,
                     "train_s": train_s}
    return out


if __name__ == "__main__":
    run()
