"""Versioned weight bank for train-while-serving SNN deployments.

1. **No torn reads.**  :class:`VersionedWeightStore` is an immutable,
   monotonically numbered weight bank with double-buffered swap
   semantics: the *serving* version is the only one traffic can see,
   candidates are staged under fresh version numbers that are never
   visible, and a promotion only queues a swap —
   :meth:`VersionedWeightStore.swap_if_pending` applies it at the
   caller's step boundary, so every batch launch pins the version it
   started with and in-flight windows always finish on the old bank.

2. **No bad promotions.**  :class:`SNNWeightRefresher` builds candidate
   banks by pushing labeled samples through the engine's
   :func:`repro_torch.engine.refresh_weights` verb (one launch of the
   stream kernel on an in-kernel-encode plan; epoch-keyed counter
   seeds, so every refresh draws fresh Poisson windows) and probes them
   on a fixed held-out set.  A candidate is promoted only if (a) its
   content fingerprint still matches the one taken at production time
   (a corrupted or torn candidate is caught at the probe gate, before
   any accuracy math) and (b) its probe accuracy is within
   ``max_regression`` of the serving bank's.

3. **Recoverability.**  With a ``state_dir`` every promoted version is
   persisted through the atomic
   :class:`repro_torch.checkpoint.CheckpointManager` (tmp-dir + rename,
   keep-k, the JAX package's layout), which gives two behaviors:
   :meth:`VersionedWeightStore.rollback` demotes the serving version
   and re-reads the previous promoted version from disk (bit-exact with
   the checkpoint), and constructing a store over an existing
   ``state_dir`` restores the newest *complete* version instead of the
   seed weights — a leftover ``step_N.tmp/`` from a crash mid-save is
   purged and ignored.  A ``state_dir`` the JAX package wrote restores
   here, and the other way round.

Banks are int32 bit-pattern tensors on the store's ``device``; the
fingerprint and the checkpoint see them as numpy ``uint32``, as the JAX
package does.
"""

from __future__ import annotations

import dataclasses
import hashlib
import shutil
import threading

import numpy as np
import torch

from repro_torch.checkpoint import CheckpointManager
from repro_torch.core.bitpack import as_words, words_to_numpy
from repro_torch.core.encoder import sample_seeds, sample_seeds_at
from repro_torch.engine import SNNEngine, SNNEnginePlan, refresh_weights
from repro_torch.serving.journal import RingLog


def weight_fingerprint(weights) -> str:
    """Content hash (shape + bytes) of a packed u32 weight bank; equal
    to the JAX package's fingerprint of the same bank."""
    arr = np.ascontiguousarray(words_to_numpy(as_words(weights)))
    h = hashlib.sha256()
    h.update(repr(arr.shape).encode())
    h.update(arr.tobytes())
    return h.hexdigest()


@dataclasses.dataclass(frozen=True)
class WeightVersion:
    """One immutable numbered weight bank.

    ``origin`` records how the version came to be: ``seed`` (the
    constructor bank), ``refresh`` (a trained candidate), ``restore``
    (read back from disk at startup), ``rollback`` (re-read after a
    demotion).  ``fingerprint`` is taken when the bank is produced;
    :meth:`verify` recomputes it, so corruption anywhere between
    production and promotion is detectable.
    """
    version: int
    weights: object                    # torch.int32[n, w] bit patterns
    fingerprint: str
    origin: str = "seed"               # seed|refresh|restore|rollback
    probe_accuracy: float | None = None

    def verify(self) -> bool:
        return weight_fingerprint(self.weights) == self.fingerprint


class VersionedWeightStore:
    """Immutable, monotonically numbered weight bank with
    double-buffered swap semantics and atomic persistence, held on
    ``device``.

    The store never mutates a bank in place: ``serving`` is replaced
    only by :meth:`swap_if_pending` and every promoted version is
    written through the checkpoint manager before it becomes
    swappable.  With no ``state_dir`` the store is memory-only
    (rollback falls back to the in-memory history of promoted
    versions).
    """

    def __init__(self, seed_weights, *, state_dir=None, keep: int = 4,
                 device=None):
        self._lock = threading.Lock()
        self.keep = keep
        self.device = device
        self.ckpt = (CheckpointManager(state_dir, keep=keep,
                                       async_save=False)
                     if state_dir is not None else None)
        # --- counters / audit trail ------------------------------------
        self.staged = 0
        self.promotions = 0            # refresh promotions (not seed)
        self.rejected = 0
        self.rollbacks = 0
        self.rollback_load_failures = 0  # missing/torn rollback targets
        self.save_crashes = 0
        self.events = RingLog(cap=256)   # bounded audit trail
        self.promoted_order: list[int] = []   # every live-able version
        self.demoted: set[int] = set()        # rolled-back versions
        self._history: dict[int, WeightVersion] = {}
        self._pending: WeightVersion | None = None

        seed_w = as_words(seed_weights, device)
        restored = None
        if self.ckpt is not None:
            purged = self.ckpt.purge_tmp()
            if purged:
                self.events.append({"event": "purged_torn_saves",
                                    "dirs": purged})
            step = self.ckpt.latest_step()
            if step is not None:
                restored = self._load(step, tuple(seed_w.shape),
                                      origin="restore")
        if restored is not None:
            self._serving = restored
            self.events.append({"event": "restored",
                                "version": restored.version})
        else:
            self._serving = WeightVersion(0, seed_w,
                                          weight_fingerprint(seed_w),
                                          origin="seed")
            if self.ckpt is not None:
                self._persist(self._serving)
        self.promoted_order.append(self._serving.version)
        self._history[self._serving.version] = self._serving
        self._next = self._serving.version + 1

    # --- persistence ---------------------------------------------------

    def _persist(self, ver: WeightVersion) -> None:
        acc = (float("nan") if ver.probe_accuracy is None
               else float(ver.probe_accuracy))
        self.ckpt.save(ver.version, {
            "weights": words_to_numpy(ver.weights),
            "probe_accuracy": np.float64(acc)})

    def _load(self, version: int, shape, *, origin: str
              ) -> WeightVersion:
        like = {"weights": np.zeros(shape, np.uint32),
                "probe_accuracy": np.float64(0)}
        tree, got = self.ckpt.restore(version, like)
        acc = float(tree["probe_accuracy"])
        w = as_words(np.asarray(tree["weights"], np.uint32), self.device)
        return WeightVersion(got, w, weight_fingerprint(w),
                             origin=origin,
                             probe_accuracy=None if np.isnan(acc)
                             else acc)

    def _write_torn(self, version: int) -> None:
        """Leave exactly what a crash mid-save leaves: a ``.tmp``
        directory with partial contents and no manifest."""
        tmp = self.ckpt.dir / f"step_{version}.tmp"
        tmp.mkdir(parents=True, exist_ok=True)
        (tmp / "weights.proc0.npy").write_bytes(b"\x93NUMPY torn")

    # --- lifecycle -----------------------------------------------------

    @property
    def serving(self) -> WeightVersion:
        """The promoted version traffic sees (pin it per batch step)."""
        return self._serving

    def stage(self, weights, *, origin: str = "refresh"
              ) -> WeightVersion:
        """Number a candidate bank.  Staged versions are invisible to
        traffic until promoted; the fingerprint is taken here, so any
        later mutation of the bank is detectable by ``verify()``."""
        with self._lock:
            v = self._next
            self._next += 1
            self.staged += 1
        w = as_words(weights, self.device)
        return WeightVersion(v, w, weight_fingerprint(w), origin=origin)

    def reject(self, cand: WeightVersion, reason: str) -> None:
        """Drop a candidate (never visible to traffic)."""
        with self._lock:
            self.rejected += 1
            self.events.append({"event": "rejected",
                                "version": cand.version,
                                "reason": reason})

    def promote(self, cand: WeightVersion, *, on_save=None) -> bool:
        """Persist a candidate and queue it for the next between-steps
        swap.  ``on_save`` (the fault hook) is consulted before the
        write with ``{"kind": "save", ...}``; if it raises, the store
        simulates the crash it models — a torn ``.tmp`` directory is
        left on disk, the promotion is aborted, and False is returned.
        Candidates must verify their fingerprint."""
        if not cand.verify():
            raise ValueError(f"refusing to promote version "
                             f"{cand.version}: fingerprint mismatch "
                             "(corrupt candidate)")
        with self._lock:
            if self.ckpt is not None:
                if on_save is not None:
                    try:
                        on_save({"kind": "save",
                                 "version": cand.version})
                    except Exception as e:  # noqa: BLE001 — crash sim
                        self.save_crashes += 1
                        self._write_torn(cand.version)
                        self.events.append({
                            "event": "save_crash",
                            "version": cand.version,
                            "error": f"{type(e).__name__}: {e}"})
                        return False
                self._persist(cand)
            self._history[cand.version] = cand
            self.promoted_order.append(cand.version)
            self.promotions += 1
            self._pending = cand
            self.events.append({"event": "promoted",
                                "version": cand.version,
                                "probe_accuracy": cand.probe_accuracy})
            # trim the in-memory history like the on-disk keep-k
            for v in sorted(self._history)[:-max(self.keep, 1)]:
                if v != self._serving.version:
                    del self._history[v]
        return True

    def swap_if_pending(self) -> bool:
        """Apply a queued promotion/rollback.  This is the ONLY place
        ``serving`` changes — call it between serving steps, never
        while a batch is in flight."""
        with self._lock:
            if self._pending is None:
                return False
            self._serving = self._pending
            self._pending = None
            return True

    # --- rollback ------------------------------------------------------

    def _rollback_target(self) -> int | None:
        cur = (self._pending or self._serving).version
        for v in reversed(self.promoted_order):
            if v != cur and v not in self.demoted:
                return v
        return None

    def can_rollback(self) -> bool:
        return self._rollback_target() is not None

    def is_live(self, version: int) -> bool:
        """Whether a version is currently serveable: promoted at some
        point and never rolled back."""
        return (version in self.promoted_order
                and version not in self.demoted)

    def get(self, version: int) -> WeightVersion | None:
        """A promoted version still in the in-memory history (keep-k
        trimmed), e.g. for per-version oracle audits."""
        return self._history.get(version)

    def _load_rollback_target(self, tgt_v: int, shape
                              ) -> WeightVersion | None:
        """One rollback target's weights, or None when they are
        unrecoverable (checkpoint missing or torn AND trimmed from the
        in-memory history).  Never raises: a torn target is counted, its
        droppings are purged, and the caller walks to the next-older
        target."""
        from_disk = (self.ckpt is not None
                     and tgt_v in self.ckpt.all_steps())
        if from_disk:
            try:
                return self._load(tgt_v, shape, origin="rollback")
            except Exception as e:  # noqa: BLE001 — torn checkpoint
                self.rollback_load_failures += 1
                self.ckpt.purge_tmp()
                shutil.rmtree(self.ckpt.dir / f"step_{tgt_v}",
                              ignore_errors=True)
                self.events.append({
                    "event": "rollback_target_torn", "version": tgt_v,
                    "error": f"{type(e).__name__}: {e}"})
        if tgt_v in self._history:
            return dataclasses.replace(self._history[tgt_v],
                                       origin="rollback")
        if not from_disk:
            self.rollback_load_failures += 1
            self.events.append({"event": "rollback_target_missing",
                                "version": tgt_v})
        return None

    def rollback(self, reason: str = "") -> WeightVersion | None:
        """Demote the serving version and queue the previous promoted
        version for the next between-steps swap, re-read from disk when
        a ``state_dir`` is present, else from the in-memory history.  A
        missing or torn target is counted (``rollback_load_failures``)
        and walked past, never raised.  The demoted version's checkpoint
        is deleted, so a restart converges with post-rollback serving.
        Returns the queued version (None when there is nothing usable
        to roll back to; the serving bank then stays live)."""
        with self._lock:
            cur = self._pending or self._serving
            shape = tuple(cur.weights.shape)
            while True:
                tgt_v = self._rollback_target()
                if tgt_v is None:
                    return None
                tgt = self._load_rollback_target(tgt_v, shape)
                if tgt is not None:
                    break
                # unrecoverable target: demote it and keep walking
                self.demoted.add(tgt_v)
            self.demoted.add(cur.version)
            if self.ckpt is not None:
                shutil.rmtree(self.ckpt.dir / f"step_{cur.version}",
                              ignore_errors=True)
            self._pending = tgt
            self.rollbacks += 1
            self.events.append({"event": "rollback",
                                "from": cur.version, "to": tgt.version,
                                "reason": reason})
            return tgt

    # --- stats ---------------------------------------------------------

    def stats(self) -> dict:
        s = self._serving
        return {
            "weight_version": s.version,
            "weight_origin": s.origin,
            "versions_staged": self.staged,
            "versions_promoted": self.promotions,
            "versions_rejected": self.rejected,
            "rollbacks": self.rollbacks,
            "rollback_load_failures": self.rollback_load_failures,
            "save_crashes": self.save_crashes,
        }


@dataclasses.dataclass(frozen=True)
class SNNRefreshPolicy:
    """Knobs of the probe-gated online refresh path.  Frozen, like the
    serving policy: one refresh contract per engine."""
    refresh_every: int = 8           # serving steps between refreshes
    probe_size: int = 32             # held-out probe samples
    max_regression: float = 0.0      # allowed probe-accuracy drop
    refresh_samples: int = 32        # training samples per refresh
    refresh_timeout_ms: float | None = None  # stalled-refresh abort

    def __post_init__(self):
        if self.refresh_every < 0:
            raise ValueError(f"refresh_every must be >= 0, got "
                             f"{self.refresh_every}")
        if self.probe_size < 1:
            raise ValueError(f"probe_size must be >= 1, got "
                             f"{self.probe_size}")
        if self.max_regression < 0:
            raise ValueError(f"max_regression must be >= 0, got "
                             f"{self.max_regression}")
        if self.refresh_samples < 1:
            raise ValueError(f"refresh_samples must be >= 1, got "
                             f"{self.refresh_samples}")
        if (self.refresh_timeout_ms is not None
                and self.refresh_timeout_ms <= 0):
            raise ValueError(f"refresh_timeout_ms must be > 0 or None, "
                             f"got {self.refresh_timeout_ms}")


class SNNWeightRefresher:
    """Builds and probes candidate weight versions for a serving engine.

    ``plan`` must be a *learning* plan (``w_exp`` set); training runs
    through :func:`repro_torch.engine.refresh_weights` on ``device``
    (``cuda`` unless the caller asks for another), on the plan's device
    grid when it holds one.
    ``intensities``/``labels`` are the labeled refresh stream
    (uint8[N, n_in] / int[N]); each refresh cycle takes the next
    ``policy.refresh_samples``-sized slice (cyclic) with epoch-keyed
    counter seeds, so every cycle re-presents data with fresh Poisson
    draws.  ``probe_intensities``/``probe_labels`` are the fixed
    held-out probe set (truncated to ``policy.probe_size``), encoded
    with fixed seeds so probe accuracy is a pure function of the
    weights.
    """

    _PROBE_SEED_SALT = 0x5EED

    def __init__(self, plan: SNNEnginePlan, intensities, labels, *,
                 n_classes: int, probe_intensities, probe_labels,
                 neuron_class, n_steps: int,
                 policy: SNNRefreshPolicy | None = None,
                 teach_pos: int = 64, teach_neg: int = -1024,
                 ltp_prob=None, device=None):
        if not plan.learn:
            raise ValueError("SNNWeightRefresher needs a learning plan "
                             "(w_exp is None)")
        self.plan = plan
        self.policy = policy if policy is not None else SNNRefreshPolicy()
        self.n_classes = int(n_classes)
        self.n_steps = int(n_steps)
        self.teach_pos, self.teach_neg = teach_pos, teach_neg
        self.ltp_prob = ltp_prob
        self.intensities = np.asarray(intensities, np.uint8)
        self.labels = np.asarray(labels, np.int64)
        if self.intensities.shape[0] != self.labels.shape[0]:
            raise ValueError("intensities and labels disagree on N")
        self.neuron_class = np.asarray(neuron_class)
        k = self.policy.probe_size
        self._probe_inten = torch.from_numpy(np.ascontiguousarray(
            np.asarray(probe_intensities, np.uint8)[:k]))
        self._probe_labels = np.asarray(probe_labels)[:k]
        self._probe_seeds = sample_seeds(
            plan.encode_seed + self._PROBE_SEED_SALT,
            int(self._probe_inten.shape[0]))
        self._train_eng = SNNEngine(plan, device)
        self.device = self._train_eng.device
        self._probe_eng = SNNEngine(dataclasses.replace(plan, w_exp=None),
                                    self.device)
        self.epochs_run = 0

    def next_candidate(self, weights) -> tuple[torch.Tensor, int]:
        """Train one candidate bank from ``weights`` on the next cyclic
        refresh slice; returns (candidate weights, refresh epoch).  The
        epoch keys both the sample seeds (fresh windows) and the
        per-block LFSR chains (fresh stochastic-STDP draws)."""
        epoch = self.epochs_run
        self.epochs_run += 1
        n = self.labels.shape[0]
        k = min(self.policy.refresh_samples, n)
        idx = (np.arange(k) + epoch * k) % n
        seeds = sample_seeds_at(self.plan.encode_seed,
                                torch.from_numpy(idx), epoch)
        b = int(weights.shape[0]) // self.n_classes
        lfsr_seeds = [((0x22A + 0x9E37 * i) ^ (0x2545 * epoch)) & 0xFFFF
                      or 0xACE1 for i in range(b)]
        cand = refresh_weights(
            self._train_eng, weights, labels=self.labels[idx],
            n_classes=self.n_classes, teach_pos=self.teach_pos,
            teach_neg=self.teach_neg,
            intensities=torch.from_numpy(self.intensities[idx]),
            seeds=seeds, n_steps=self.n_steps, lfsr_seeds=lfsr_seeds,
            ltp_prob=self.ltp_prob)
        return cand, epoch

    def probe(self, weights) -> float:
        """Held-out accuracy of a bank on the fixed probe set — a pure
        function of the weights (fixed samples, fixed seeds)."""
        counts = self._probe_eng.infer(
            weights, intensities=self._probe_inten,
            seeds=self._probe_seeds, n_steps=self.n_steps).cpu().numpy()
        pred = self.neuron_class[np.argmax(counts, axis=1)]
        return float(np.mean(pred == self._probe_labels))
