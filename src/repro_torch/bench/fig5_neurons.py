"""Paper Figure 5: classification accuracy vs output-layer size.

The port's counterpart of ``benchmarks/fig5_neurons.py``.  Paper
(MNIST): 10 -> 80.94%, 20 -> 86.91%, 40 -> 91.91%.  The claim being
validated is the monotone CA growth from active learning, on the
offline digit set, trained on the card.  The test digits are classified
from their intensities (the in-kernel encode, seeds from base 99).
"""

from __future__ import annotations

import dataclasses
import time

from repro_torch.bench.common import (digits_dataset, emit, encode_test_set,
                                      n_correct, train_timed)
from repro_torch.configs.wenquxing_snn import WENQUXING_22A_INTENSITY

PAPER = {10: 0.8094, 20: 0.8691, 40: 0.9191}
TEST_SEED = 99


def run(dataset=None, *, n_train=2000, n_test=1000,
        neuron_counts=(10, 20, 40), n_steps=WENQUXING_22A_INTENSITY.n_steps,
        epochs=WENQUXING_22A_INTENSITY.epochs, device="cuda",
        block_seeds=None) -> dict:
    tr, tr_lab, te, te_lab = (dataset if dataset is not None else
                              digits_dataset(n_train=n_train, n_test=n_test))
    inten, seeds = encode_test_set(te, TEST_SEED, device)
    out, correct, train_s, models = {}, {}, {}, {}
    for n in neuron_counts:
        cfg = dataclasses.replace(WENQUXING_22A_INTENSITY, n_neurons=n,
                                  n_steps=n_steps, epochs=epochs)
        t0 = time.perf_counter()
        models[n], train_s[n] = train_timed(cfg, tr, tr_lab, device=device,
                                        block_seeds=block_seeds)
        correct[n] = n_correct(models[n], inten, seeds, te_lab)
        acc = correct[n] / len(te_lab)
        emit(f"fig5/neurons-{n}", (time.perf_counter() - t0) * 1e6,
             f"CA={acc:.4f};paper={PAPER[n]:.4f}" if n in PAPER else
             f"CA={acc:.4f}")
        out[n] = acc
    accs = [out[n] for n in neuron_counts]
    mono = all(a <= b for a, b in zip(accs, accs[1:]))
    emit("fig5/monotone-trend", None, f"monotone={mono}")
    return {"accuracy": out, "correct": correct, "monotone": mono,
            "models": models, "train_s": train_s}


if __name__ == "__main__":
    run()
