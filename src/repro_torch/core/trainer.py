"""Supervised STDP trainer + "Active learning" (paper §3.1).

A 10-neuron block has one neuron per digit class: a teacher current
drives the labeled neuron while the others are inhibited.

Networks of more than 10 neurons ("active learning"): train 10 neurons,
classify the training set, then train a fresh block of 10 on the
misclassified samples only; repeat up to the population size.
Classification is by the class of the most-firing neuron over all
blocks.

``train_mode="parallel"`` instead trains every block at once on the
full set: each presented sample covers all blocks (per-block regfiles,
decorrelated by their LFSR seeds), with block 0 at ``ltp_prob`` and
later blocks at ``ltp_prob_active``, as in active mode.

With ``encode="kernel"`` on the window path an epoch of a block (active)
or of all blocks (parallel) is one stream-kernel launch; otherwise one
launch per presented sample.

Ingestion follows ``encode``: ``"kernel"`` quantizes the images once to
uint8 on the host and every presentation draws its spike window inside
the kernel from per-sample counter seeds (epoch-keyed, so every epoch
has fresh draws); ``"host"`` pre-encodes the set into packed windows
with a ``torch.Generator`` (statistically, not bit for bit, the JAX
package's encode).

``cycle_backend="step"`` runs every presentation (and every
classification) cycle by cycle, one fused RV-SNN step launch per cycle,
instead of one window launch; the two are bit-exact.

Randomness is explicit: :func:`train` takes the per-block LFSR base
seeds (``block_seeds``) or draws them from a CPU generator seeded from
``cfg.seed``.  Everything runs on the device the caller names (``cuda``
by default) through :class:`~repro_torch.engine.SNNEngine`.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from repro_torch.core.bitpack import n_words
from repro_torch.core.encoder import (poisson_encode_batch,
                                      quantize_intensities, sample_seeds,
                                      sample_seeds_at)
from repro_torch.core.lif import LIFParams, lif_params
from repro_torch.core.rvsnn import snn_regfile, snn_regfile_batch
from repro_torch.core.stdp import STDPParams, init_weights, stdp_params
from repro_torch.engine import (SNNEngine, plan_from_config, resolve_device,
                                train_stream, train_stream_batch)

_TRAIN_MODES = ("active", "parallel")


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
    teach_pos: int = 64          # teacher current into the labeled neuron
    teach_neg: int = -1024       # inhibition into the others
    epochs: int = 2
    seed: int = 0x22A
    cycle_backend: str = "window"    # "window" | "step" (per-cycle)
    kernel_backend: str = "kernel"   # "kernel" | "ref"
    train_mode: str = "active"       # "active" | "parallel"
    window_chunk: int | None = None  # accepted; the kernels stream T
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

    def lif(self) -> LIFParams:
        return lif_params(self.threshold, self.leak)

    def stdp(self, block_idx: int = 0) -> STDPParams:
        lp = self.ltp_prob if block_idx == 0 else self.ltp_prob_active
        return stdp_params(self.n_inputs, self.w_exp, self.gain, lp)

    def plan(self, block_idx: int = 0):
        """The engine execution plan this config describes."""
        return plan_from_config(self, block_idx)


@dataclass
class SNNModel:
    """Trained population: packed weights + per-neuron class labels."""
    weights: torch.Tensor          # int32[n_neurons, w] bit patterns
    neuron_class: torch.Tensor     # int32[n_neurons], on the same device
    cfg: SNNTrainConfig = field(repr=False, default=None)
    presentations: int = 0         # (sample, block) pairs trained on


def _teacher(labels: torch.Tensor, cfg: SNNTrainConfig) -> torch.Tensor:
    """int32[N, n_classes] teacher currents for a 10-neuron block."""
    onehot = torch.nn.functional.one_hot(labels.to(torch.int64),
                                         cfg.n_classes).to(torch.int32)
    return onehot * cfg.teach_pos + (1 - onehot) * cfg.teach_neg


def _train_block(cfg: SNNTrainConfig, lfsr_seed: int,
                 labels: torch.Tensor, block_idx: int, *,
                 spike_trains: torch.Tensor | None = None,
                 intensities: torch.Tensor | None = None,
                 sample_idx: torch.Tensor | None = None) -> torch.Tensor:
    """Train one 10-neuron block online over the sample stream, on the
    device the labels lie on.

    The stream is EITHER pre-encoded ``spike_trains`` int32[N, T, w] OR
    uint8 ``intensities`` [N, n_inputs] with their dataset indices
    ``sample_idx`` i32[N], whose counter seeds are epoch-keyed
    (``sample_seeds_at(encode_seed, idx, epoch)``).  ``lfsr_seed`` is
    the block's LFSR base seed.  Returns the block's weights
    int32[n_classes, w].
    """
    dev = labels.device
    w0 = init_weights(cfg.n_classes, cfg.words, dense=True, device=dev)
    rf = snn_regfile(w0, seed=lfsr_seed)
    teach = _teacher(labels, cfg)
    eng = SNNEngine(cfg.plan(block_idx), device=dev)
    for epoch in range(cfg.epochs):
        if intensities is not None:
            rf, _ = train_stream(
                eng, rf, teach=teach, intensities=intensities,
                seeds=sample_seeds_at(cfg.encode_seed, sample_idx, epoch),
                n_steps=cfg.n_steps)
        else:
            rf, _ = train_stream(eng, rf, spike_trains, teach)
    return rf.weights


def _train_blocks_parallel(cfg: SNNTrainConfig, lfsr_seeds,
                           labels: torch.Tensor, *,
                           spike_trains: torch.Tensor | None = None,
                           intensities: torch.Tensor | None = None,
                           sample_idx: torch.Tensor | None = None
                           ) -> torch.Tensor:
    """Train all blocks concurrently on the full set, B = n_blocks
    streams in every launch.  Blocks differ by their LFSR seeds (``lfsr_seeds``, one per
    block) and their LTP schedule (block 0 ``ltp_prob``, the rest
    ``ltp_prob_active``).  The sample stream is as in
    :func:`_train_block`, shared by every block.  Returns weights
    int32[n_neurons, w].
    """
    dev = labels.device
    b = cfg.n_blocks
    w0 = init_weights(cfg.n_classes, cfg.words, dense=True,
                      device=dev)[None].repeat(b, 1, 1)
    rfs = snn_regfile_batch(w0, lfsr_seeds)
    teach = _teacher(labels, cfg)
    teach_b = teach.expand((b,) + teach.shape)
    lp = torch.tensor([cfg.ltp_prob if i == 0 else cfg.ltp_prob_active
                       for i in range(b)], dtype=torch.int32, device=dev)
    eng = SNNEngine(cfg.plan(0), device=dev)
    for epoch in range(cfg.epochs):
        if intensities is not None:
            rfs, _ = train_stream_batch(
                eng, rfs, teach=teach_b, ltp_prob=lp,
                intensities=intensities.expand((b,) + intensities.shape),
                seeds=sample_seeds_at(cfg.encode_seed, sample_idx, epoch),
                n_steps=cfg.n_steps)
        else:
            rfs, _ = train_stream_batch(
                eng, rfs, spike_trains.expand((b,) + spike_trains.shape),
                teach_b, ltp_prob=lp)
    return rfs.weights.reshape(b * cfg.n_classes, cfg.words)


def classify(model: SNNModel, spike_trains: torch.Tensor | None = None,
             *, intensities: torch.Tensor | None = None,
             seeds=None) -> torch.Tensor:
    """Predicted class int32[B]: the class of the most-firing neuron
    (the first on ties).  Takes pre-encoded ``spike_trains``
    int32[B, T, w] or uint8 ``intensities`` [B, n_inputs] (+ per-sample
    ``seeds``), presented over ``cfg.n_steps`` cycles through the
    plan's ``infer`` verb on the model's device."""
    eng = SNNEngine(model.cfg.plan(), device=model.weights.device)
    if intensities is not None:
        counts = eng.infer(model.weights, intensities=intensities,
                           seeds=seeds, n_steps=model.cfg.n_steps)
    else:
        counts = eng.infer(model.weights, spike_trains)
    return model.neuron_class[counts.argmax(dim=-1)]


def accuracy(model: SNNModel, spike_trains: torch.Tensor | None = None,
             labels=None, *, intensities: torch.Tensor | None = None,
             seeds=None) -> float:
    """The fraction of correct predictions (in double precision; the JAX
    package's float32 mean may differ in the last float32 place)."""
    pred = classify(model, spike_trains, intensities=intensities,
                    seeds=seeds)
    labels = torch.as_tensor(labels, device=pred.device)
    return int((pred == labels).sum()) / pred.numel()


def _block_seeds(cfg: SNNTrainConfig, g: torch.Generator) -> list[int]:
    """Per-block LFSR base seeds in [1, 65535] from ``g``.  Parallel mode
    draws them without replacement: blocks differ only by these seeds
    (``lfsr.seed`` folds its base to 16 bits), so no two may collide."""
    b = cfg.n_blocks
    if cfg.train_mode == "parallel":
        return (torch.randperm((1 << 16) - 1, generator=g)[:b] + 1).tolist()
    return torch.randint(1, 1 << 16, (b,), generator=g).tolist()


def train(cfg: SNNTrainConfig, images, labels, *,
          generator: torch.Generator | None = None, block_seeds=None,
          device=None) -> SNNModel:
    """Full training (active learning, or all blocks in parallel).

    images float32[N, n_inputs] normalized (already preprocessed);
    labels int[N].  ``block_seeds`` gives each block's LFSR base seed
    (n_blocks ints); without it they are drawn from ``generator`` (a
    CPU generator, default seeded from ``cfg.seed``), which also drives
    the ``encode="host"`` Poisson encode.  Images are quantized (or
    encoded) on the host and then moved to ``device`` (``cuda`` unless
    the caller asks for another), so a card run and a CPU run see the
    same inputs.
    """
    if cfg.train_mode not in _TRAIN_MODES:
        raise ValueError(f"train_mode must be one of {_TRAIN_MODES}, got "
                         f"{cfg.train_mode!r}")
    dev = resolve_device(device)
    g = (generator if generator is not None
         else torch.Generator().manual_seed(cfg.seed))
    images = torch.from_numpy(np.array(images, np.float32))
    labels_t = torch.as_tensor(np.asarray(labels), dtype=torch.int32,
                               device=dev)
    n = images.shape[0]
    if cfg.encode == "kernel":
        spike_trains = None
        intensities = quantize_intensities(images).to(dev)
        seeds = sample_seeds(cfg.encode_seed, n, device=dev)
        sample_idx = torch.arange(n, dtype=torch.int32, device=dev)
    else:
        spike_trains = poisson_encode_batch(g, images, cfg.n_steps).to(dev)
        intensities = seeds = sample_idx = None
    if block_seeds is None:
        block_seeds = _block_seeds(cfg, g)
    block_seeds = [int(s) for s in block_seeds]
    if len(block_seeds) < cfg.n_blocks:
        raise ValueError(f"need {cfg.n_blocks} block seeds, got "
                         f"{len(block_seeds)}")
    classes = torch.arange(cfg.n_classes, dtype=torch.int32, device=dev)

    if cfg.train_mode == "parallel":
        weights = _train_blocks_parallel(
            cfg, block_seeds[:cfg.n_blocks], labels_t,
            spike_trains=spike_trains, intensities=intensities,
            sample_idx=sample_idx)
        return SNNModel(weights, classes.repeat(cfg.n_blocks), cfg,
                        n * cfg.n_blocks * cfg.epochs)

    blocks: list[torch.Tensor] = []
    presentations = 0
    cur = (spike_trains, intensities, sample_idx, labels_t)
    for b in range(cfg.n_blocks):
        cur_trains, cur_inten, cur_idx, cur_labels = cur
        blocks.append(_train_block(
            cfg, block_seeds[b], cur_labels, b, spike_trains=cur_trains,
            intensities=cur_inten, sample_idx=cur_idx))
        presentations += len(cur_labels) * cfg.epochs
        if b + 1 == cfg.n_blocks:
            break
        # active learning: the next block trains on this ensemble's errors
        model = SNNModel(torch.cat(blocks), classes.repeat(len(blocks)), cfg)
        pred = (classify(model, intensities=intensities, seeds=seeds)
                if intensities is not None else
                classify(model, spike_trains))
        err = (pred != labels_t).nonzero().flatten()
        if err.numel() == 0:
            break
        # error samples keep their original dataset indices: the same
        # (seed, epoch, intensity) derivation on every re-presentation
        if intensities is not None:
            cur = (None, intensities[err], sample_idx[err], labels_t[err])
        else:
            cur = (spike_trains[err], None, None, labels_t[err])
    return SNNModel(torch.cat(blocks), classes.repeat(len(blocks)), cfg,
                    presentations)
