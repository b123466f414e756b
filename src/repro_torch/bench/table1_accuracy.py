"""Paper Table 1: MNIST recognition comparison.

The port's counterpart of ``benchmarks/table1_accuracy.py``.  Reproduces
the "this work" row (784-40, 1-bit synapses, binary stochastic STDP,
rate coding) on the offline procedural digit set, trained on the card,
alongside the paper's reported numbers for context.  The oracle ceiling
row quantifies the dataset substitution.  The test digits are
classified from their intensities (the in-kernel encode, seeds from
base 99).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.bench.common import (digits_dataset, emit, encode_test_set,
                                      n_correct, train_timed)
from repro_torch.configs.wenquxing_snn import WENQUXING_22A_INTENSITY

PAPER_ROWS = [
    ("Neftci2014-784-500-40-8bit", 0.916),
    ("ODIN-784-10-3bit", 0.850),
    ("Yousefzadeh2018-784-6400-1bit", 0.957),
    ("Wenquxing22A-paper-784-40-1bit", 0.9191),
]
TEST_SEED = 99


def oracle_ceiling(tr, tr_lab, te, te_lab, k=128) -> float:
    protos = np.zeros((10, 784), bool)
    for c in range(10):
        mean = tr[tr_lab == c].mean(0)
        protos[c, np.argsort(mean)[-k:]] = True
    scores = te @ protos.T.astype(np.float32)
    return float((scores.argmax(1) == te_lab).mean())


def run(dataset=None, *, n_train=2000, n_test=1000, n_neurons=40,
        n_steps=WENQUXING_22A_INTENSITY.n_steps,
        epochs=WENQUXING_22A_INTENSITY.epochs, device="cuda",
        block_seeds=None) -> dict:
    tr, tr_lab, te, te_lab = (dataset if dataset is not None else
                              digits_dataset(n_train=n_train, n_test=n_test))
    # 784-40, 1-bit, the paper's best setting
    cfg = dataclasses.replace(WENQUXING_22A_INTENSITY, n_neurons=n_neurons,
                              n_steps=n_steps, epochs=epochs)
    model, train_s = train_timed(cfg, tr, tr_lab, device=device,
                                 block_seeds=block_seeds)
    inten, seeds = encode_test_set(te, TEST_SEED, device)
    correct = n_correct(model, inten, seeds, te_lab)
    acc = correct / len(te_lab)
    ceiling = oracle_ceiling(tr, tr_lab, te, te_lab)

    for name, ca in PAPER_ROWS:
        emit(f"table1/{name}", None, f"CA={ca:.4f} (reported,MNIST)")
    emit(f"table1/this-work-784-{n_neurons}-1bit", train_s * 1e6,
         f"CA={acc:.4f} (procedural digits)")
    emit("table1/oracle-binary-prototype-K128", None,
         f"CA={ceiling:.4f} (dataset ceiling)")
    return {"accuracy": acc, "correct": correct, "ceiling": ceiling,
            "model": model, "train_s": train_s}


if __name__ == "__main__":
    run()
