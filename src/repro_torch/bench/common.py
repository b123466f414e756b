"""Shared utilities of the paper's scripts: dataset, training, test
encode, timing, CSV emission.

The port's counterpart of the JAX package's ``benchmarks/common.py``.
``emit`` and ``RECORDS`` are its code.  The one deliberate difference
from the JAX scripts is the encode: they draw their test windows (and
``WENQUXING_22A``'s training windows) with ``jax.random``, which torch
cannot reproduce, so the port's scripts train on
``WENQUXING_22A_INTENSITY`` (the counter encode both packages share) and
present uint8 ``quantize_intensities(te)`` with
``sample_seeds(base, n_test)``: ``base`` 7 in Fig. 4 and 99 elsewhere,
after the JAX scripts' keys.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from repro_torch.core.encoder import quantize_intensities, sample_seeds
from repro_torch.core.preprocess import preprocess_batch
from repro_torch.core.trainer import SNNModel, SNNTrainConfig, classify, train
from repro_torch.data.digits import make_digits
from repro_torch.engine import resolve_device

_CACHE: dict = {}

# Every emit() call also lands here so run.py --json can serialize the
# whole sweep (name -> us_per_call + parsed derived k=v metrics).
RECORDS: list[dict] = []


def digits_dataset(n_train=2000, n_test=1000, seed=1):
    """Preprocessed (deskew + soft-threshold) procedural digit split."""
    key = (n_train, n_test, seed)
    if key not in _CACHE:
        tr_img, tr_lab = make_digits(n_train, seed=seed)
        te_img, te_lab = make_digits(n_test, seed=seed + 1)
        tr = preprocess_batch(torch.from_numpy(tr_img.reshape(-1, 28, 28)),
                              0.1).reshape(-1, 784).numpy()
        te = preprocess_batch(torch.from_numpy(te_img.reshape(-1, 28, 28)),
                              0.1).reshape(-1, 784).numpy()
        _CACHE[key] = (tr, tr_lab, te, te_lab)
    return _CACHE[key]


def _synchronize(device) -> None:
    """Wait for the card's queued work when ``device`` is a card."""
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def time_fn(fn, *args, reps=10, warmup=2, device="cuda"):
    """Median wall time (us) of ``fn(*args)``, each call synchronized
    with the card when ``device`` is one."""
    for _ in range(warmup):
        fn(*args)
        _synchronize(device)
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn(*args)
        _synchronize(device)
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts) * 1e6)


def train_timed(cfg: SNNTrainConfig, tr, tr_lab, *, device,
                block_seeds=None) -> tuple[SNNModel, float]:
    """``train(cfg, tr, tr_lab)`` on ``device``: the model and its wall
    seconds.  ``block_seeds`` is None (the trainer draws the per-block
    LFSR seeds from ``cfg.seed``) or a function of ``cfg`` giving them."""
    dev = resolve_device(device)
    seeds = None if block_seeds is None else block_seeds(cfg)
    t0 = time.perf_counter()
    model = train(cfg, tr, tr_lab, block_seeds=seeds, device=dev)
    _synchronize(dev)
    return model, time.perf_counter() - t0


def encode_test_set(te, base: int, device) -> tuple[torch.Tensor,
                                                     torch.Tensor]:
    """The test set as the counter encode takes it: uint8 intensities
    [n, 784] and their seeds ``sample_seeds(base, n)``, on ``device``."""
    dev = resolve_device(device)
    inten = quantize_intensities(np.array(te, np.float32)).to(dev)
    return inten, sample_seeds(base, inten.shape[0], device=dev)


def n_correct(model: SNNModel, inten, seeds, labels) -> int:
    """Correct predictions of ``model`` on the intensities (classified
    through the in-kernel encode on a card)."""
    pred = classify(model, intensities=inten, seeds=seeds)
    return int((pred.cpu() == torch.as_tensor(np.asarray(labels))).sum())


def emit(name: str, us_per_call: float | None, derived: str) -> None:
    """Print one CSV row and record it for --json.

    ``us_per_call=None`` marks an analytic-only row (derived metrics
    with nothing timed): the timing field is left empty and the record
    carries ``analytic: true`` instead of a bogus 0.0 that the perf
    gate or history plots could mistake for a measurement.
    """
    if us_per_call is None:
        print(f"{name},,{derived};analytic=true")
        rec: dict = {"name": name, "analytic": True}
    else:
        print(f"{name},{us_per_call:.2f},{derived}")
        rec = {"name": name, "us_per_call": float(us_per_call)}
    for part in derived.split(";"):
        if "=" not in part:
            continue
        k, v = part.split("=", 1)
        v = v.rstrip("x")
        try:
            rec[k] = float(v)
        except ValueError:
            rec[k] = v
    RECORDS.append(rec)
