"""Crash-consistent request journal for the SNN serving engine.

:class:`RequestJournal` is the durability substrate under
:class:`~repro_torch.serving.snn.SNNServingEngine`: an append-only, fsync'd,
CRC-framed write-ahead log of request lifecycle events plus periodic
engine-state snapshots that truncate the log.  A process can die at any
instant — ``kill -9``, power loss, an injected ``os._exit`` from
:mod:`repro_torch.serving.faults` — and a restarted engine recovers every
admitted request and every counter the dead process had made durable.

Journal layout (one directory per engine)::

    snapshot_<seq>.json      # engine state at the start of segment <seq>
    snapshot_<seq>.json.tmp  # torn snapshot (crash mid-write) — ignored
    wal_<seq>.log            # CRC-framed events appended after snapshot <seq>
    ledger.log               # append-only terminal ledger (never truncated)

**WAL framing.**  Each record is ``<u32 len><u32 crc32>`` followed by
``len`` bytes of canonical JSON.  Appends are buffered; :meth:`sync`
flushes and ``fsync``\\ s, so the engine chooses its durability points
(group commit at batch dispatch and at step end).  On recovery a
*partial final* record — fewer bytes on disk than its header promises,
or a final record whose CRC fails (page tearing) — is truncated away:
it was never acknowledged durable.  A CRC mismatch on a *mid-log*
record means bit rot of acknowledged state and raises
:class:`JournalError` loudly; silently dropping acknowledged events
could re-serve or lose requests.

**Event records.**  Three event kinds, written by the engine:

* ``A`` (ADMIT) — rid, intended-arrival timestamp, priority, deadline,
  the payload *descriptor* (a :class:`repro_torch.loadgen.workload` trace
  row when the request came from a trace — payload bytes regenerate
  from its seed — or the inline payload otherwise) and the payload
  content hash.
* ``D`` (DISPATCH) — the rids of one formed batch, the pinned weight
  version, and the batch's pad waste.  Purely attributive: recovery
  treats dispatched-but-unterminated exactly like admitted.
* ``T`` (TERMINAL) — rid, terminal status, served weight version,
  queue-wait / service latency, completion time, content hash.

**Snapshots.**  :meth:`snapshot` writes the engine's full state (queue
contents as ADMIT records, robustness counters, latency histograms via
their JSON round-trip, degradation rung, live weight version, clock
time) to ``snapshot_<seq+1>.json.tmp``, fsyncs, renames, then rotates
the WAL: a new empty ``wal_<seq+1>.log`` is opened and the previous
segment is deleted.  A crash mid-snapshot leaves only the ``.tmp``
(ignored on recovery — the previous snapshot + full log win); a crash
after the rename but before the new segment opens leaves a stale
``wal_<seq>.log`` whose events are already folded into the snapshot —
recovery reads only the segment matching the newest complete snapshot,
so stale segments are dead weight, deleted on the next rotation.

**Recovery** (:meth:`recover` + :func:`replay`) folds the newest
complete snapshot and its WAL tail into a :class:`RecoveredState`:
counters and histograms advance by the tail's TERMINAL events, ADMITs
without a TERMINAL become the re-queue set (in admission order), and
``resume_offset`` is one past the highest rid ever journaled — the
trace offset a resumed load run continues from.

**Terminal ledger.**  ``ledger.log`` is the exactly-once audit trail:
one CRC-framed record per terminal request, appended *after* the WAL
terminal record is fsync'd and never truncated by snapshots.  Because
a rid is re-queued only when its WAL terminal is missing, and a ledger
entry exists only when that WAL terminal was durable, a rid can never
acquire two ledger entries — the property the kill–restart chaos
harness audits (zero lost admits, zero duplicate serves by content
hash).
"""

from __future__ import annotations

import collections.abc
import dataclasses
import json
import os
import struct
import zlib
from pathlib import Path
from typing import Callable

_FRAME_HDR = struct.Struct("<II")     # (payload length, crc32)
_MAX_RECORD = 64 << 20                # sanity bound on one record


class JournalError(RuntimeError):
    """Acknowledged journal state failed verification (mid-log CRC
    mismatch, unparseable snapshot/record).  Never raised for a torn
    *tail* — that is truncated silently, it was never durable."""


class RingLog(collections.abc.Sequence):
    """Fixed-capacity append-only event log: keeps the most recent
    ``cap`` entries and counts the rest in ``dropped``, so week-long
    serving runs carry bounded telemetry instead of an unbounded list.
    Supports the list operations the telemetry consumers use (len,
    indexing incl. negative, iteration, ``append``)."""

    def __init__(self, cap: int = 256, items=None):
        if cap < 1:
            raise ValueError(f"cap must be >= 1, got {cap}")
        self.cap = int(cap)
        self.dropped = 0
        self._items: list = []
        for it in (items or []):
            self.append(it)

    def append(self, item) -> None:
        self._items.append(item)
        if len(self._items) > self.cap:
            del self._items[0]
            self.dropped += 1

    def __len__(self) -> int:
        return len(self._items)

    def __getitem__(self, i):
        return self._items[i]

    def __iter__(self):
        return iter(self._items)

    def to_list(self) -> list:
        return list(self._items)

    def __repr__(self) -> str:
        return (f"RingLog(cap={self.cap}, kept={len(self._items)}, "
                f"dropped={self.dropped})")


def _canon(obj) -> bytes:
    return json.dumps(obj, sort_keys=True,
                      separators=(",", ":")).encode()


def _frame(payload: bytes) -> bytes:
    return _FRAME_HDR.pack(len(payload), zlib.crc32(payload)) + payload


def read_frames(data: bytes, *, where: str = "log"
                ) -> tuple[list[dict], int]:
    """Decode a CRC-framed byte stream.  Returns ``(records,
    valid_len)`` where ``valid_len`` is the byte length of the intact
    prefix — shorter than ``len(data)`` exactly when the final record
    is torn (partial header, partial payload, or CRC-failed tail).  A
    CRC mismatch on any record *before* the last raises
    :class:`JournalError`: that record was acknowledged durable."""
    records: list[dict] = []
    off = 0
    n = len(data)
    while off < n:
        if n - off < _FRAME_HDR.size:
            return records, off                      # torn header
        length, crc = _FRAME_HDR.unpack_from(data, off)
        if length > _MAX_RECORD or n - off - _FRAME_HDR.size < length:
            return records, off                      # torn payload
        payload = data[off + _FRAME_HDR.size:
                       off + _FRAME_HDR.size + length]
        end = off + _FRAME_HDR.size + length
        if zlib.crc32(payload) != crc:
            if end >= n:
                return records, off                  # torn final record
            raise JournalError(
                f"{where}: CRC mismatch on record {len(records)} at "
                f"byte {off} (mid-log corruption of acknowledged "
                f"state)")
        try:
            records.append(json.loads(payload))
        except json.JSONDecodeError as e:
            raise JournalError(
                f"{where}: unparseable record {len(records)} at byte "
                f"{off}: {e}") from e
        off = end
    return records, off


def _fsync_dir(path: Path) -> None:
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


@dataclasses.dataclass
class RecoveredState:
    """One journal's replayed state: what a restarted engine adopts."""
    counters: dict                 # scalar engine counters
    qw_hist: dict | None           # LatencyHistogram.to_dict() or None
    sv_hist: dict | None
    pending: list[dict]            # ADMIT records lacking a TERMINAL
    last_rid: int                  # highest rid ever journaled (-1 none)
    weight_version: int | None     # live version at last durable point
    clock_ms: float                # engine clock high-water mark
    t_first_ms: float | None
    t_last_ms: float | None
    deg_events: list[dict]
    deg_dropped: int
    level: int                     # degradation rung at snapshot time
    snapshotted: bool              # a complete snapshot existed
    overload: dict | None = None   # OverloadController.state_dict()
    breakers: list | None = None   # per-rung circuit-breaker states

    @property
    def resume_offset(self) -> int:
        """One past the highest journaled rid: the trace offset a
        resumed load run continues from."""
        return self.last_rid + 1


_COUNTER_KEYS = (
    "steps", "batches", "windows_served", "slots_offered",
    "slots_padded", "submitted", "rejected", "expired", "failed",
    "retried", "degraded", "integrity_failures", "canary_checks",
    "canary_failures", "healthy_steps", "refresh_runs",
    "refresh_rejected", "refresh_corrupt", "refresh_timeouts",
    "refresh_failed", "version_violations",
    "shed_admission", "shed_low_priority", "shed_codel",
    "retries_denied",
)

_STATUS_COUNTER = {"SERVED": "windows_served", "REJECTED": "rejected",
                   "EXPIRED": "expired", "FAILED": "failed"}

# TERMINAL records tag overload sheds so tail replay re-attributes the
# shed counters exactly; tags from a future schema are ignored (the
# status counter above still advances)
_SHED_COUNTER = {"adm": "shed_admission", "lowprio": "shed_low_priority",
                 "codel": "shed_codel"}


def replay(snapshot: dict | None, tail: list[dict]) -> RecoveredState:
    """Fold a snapshot and its WAL tail into the recovered state.

    Pure function of the journal contents, shared by the engine's
    restart path and the chaos harness's audit.  TERMINAL events
    advance counters and histograms; ADMITs without a TERMINAL stay
    pending in admission order (re-queue set); duplicate terminal
    serves are impossible by construction (a rid re-queues only when
    its terminal record was never durable), so replay does not need to
    deduplicate — it asserts instead.
    """
    from repro_torch.loadgen.histogram import LatencyHistogram

    counters = {k: 0 for k in _COUNTER_KEYS}
    qw = LatencyHistogram()
    sv = LatencyHistogram()
    pending: dict[int, dict] = {}
    last_rid = -1
    weight_version: int | None = None
    clock_ms = 0.0
    t_first: float | None = None
    t_last: float | None = None
    deg_events: list[dict] = []
    deg_dropped = 0
    level = 0
    if snapshot is not None:
        # adopt every snapshot counter, known or not: unknown keys come
        # from a different schema generation (an older engine reading a
        # newer snapshot, or vice versa) and are preserved-and-ignored
        # rather than breaking replay
        for k, v in snapshot["counters"].items():
            counters[k] = int(v)
        if snapshot.get("qw_hist"):
            qw = LatencyHistogram.from_dict(snapshot["qw_hist"])
        if snapshot.get("sv_hist"):
            sv = LatencyHistogram.from_dict(snapshot["sv_hist"])
        for rec in snapshot.get("queue", []):
            pending[int(rec["rid"])] = rec
        last_rid = int(snapshot.get("last_rid", -1))
        weight_version = snapshot.get("weight_version")
        clock_ms = float(snapshot.get("clock_ms", 0.0))
        t_first = snapshot.get("t_first_ms")
        t_last = snapshot.get("t_last_ms")
        deg_events = list(snapshot.get("deg_events", []))
        deg_dropped = int(snapshot.get("deg_dropped", 0))
        level = int(snapshot.get("level", 0))
    terminal_seen: set[int] = set()
    for ev in tail:
        kind = ev.get("ev")
        if kind == "A":
            rid = int(ev["rid"])
            pending[rid] = ev
            counters["submitted"] += 1
            last_rid = max(last_rid, rid)
            ts = float(ev["ts"])
            t_first = ts if t_first is None else min(t_first, ts)
        elif kind == "T":
            rid = int(ev["rid"])
            if rid in terminal_seen:
                raise JournalError(
                    f"duplicate TERMINAL for rid {rid} in one journal "
                    f"segment (exactly-once broken)")
            terminal_seen.add(rid)
            pending.pop(rid, None)
            status = ev["st"]
            key = _STATUS_COUNTER.get(status)
            if key is None:
                raise JournalError(
                    f"rid {rid}: unknown terminal status {status!r}")
            counters[key] += 1
            shed_key = _SHED_COUNTER.get(ev.get("shed"))
            if shed_key is not None:
                counters[shed_key] += 1
            if status == "SERVED":
                if ev.get("qw") is not None:
                    qw.record(float(ev["qw"]))
                if ev.get("sv") is not None:
                    sv.record(float(ev["sv"]))
                if ev.get("ver") is not None:
                    weight_version = int(ev["ver"])
            # a reject at submit time never had an ADMIT; count the
            # offer so resume never re-offers the row
            counters["submitted"] += int(ev.get("noadmit", 0))
            last_rid = max(last_rid, rid)
            at = ev.get("at")
            if at is not None:
                clock_ms = max(clock_ms, float(at))
                t_last = (float(at) if t_last is None
                          else max(t_last, float(at)))
        elif kind == "D":
            counters["steps"] = max(counters["steps"],
                                    int(ev["step"]) + 1)
            counters["batches"] = counters["steps"]
            counters["slots_offered"] += int(ev["n"]) + int(ev["pad"])
            counters["slots_padded"] += int(ev["pad"])
            if ev.get("ver") is not None:
                weight_version = int(ev["ver"])
            at = ev.get("at")
            if at is not None:
                clock_ms = max(clock_ms, float(at))
        else:
            raise JournalError(f"unknown event kind {kind!r}")
    ordered = sorted(pending.values(), key=lambda r: int(r["rid"]))
    return RecoveredState(
        counters=counters, qw_hist=qw.to_dict(), sv_hist=sv.to_dict(),
        pending=ordered, last_rid=last_rid,
        weight_version=weight_version, clock_ms=clock_ms,
        t_first_ms=t_first, t_last_ms=t_last, deg_events=deg_events,
        deg_dropped=deg_dropped, level=level,
        snapshotted=snapshot is not None,
        overload=(snapshot or {}).get("overload"),
        breakers=(snapshot or {}).get("breakers"))


class RequestJournal:
    """Append-only, fsync'd, CRC-framed WAL + snapshot pair for one
    serving engine (see the module docstring for the protocol).

    Appends land in an explicit user-space buffer; :meth:`sync` writes
    the buffer to the file descriptor and ``fsync``\\ s it.  Process
    death (``kill -9``, ``os._exit``) loses exactly the buffered,
    un-synced suffix — :meth:`abandon` simulates that in-process for
    tests by dropping the buffers and closing the raw fds."""

    LEDGER = "ledger.log"

    def __init__(self, directory: str | Path):
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.seq = 0
        self.snapshots_taken = 0
        self.records_appended = 0
        self.syncs = 0
        self.torn_tail_truncated = 0
        self._wal_fd: int | None = None
        self._wal_buf = bytearray()
        self._ledger_fd: int | None = None
        self._ledger_buf = bytearray()

    # --- paths ---------------------------------------------------------

    def _snap_path(self, seq: int) -> Path:
        return self.dir / f"snapshot_{seq}.json"

    def _wal_path(self, seq: int) -> Path:
        return self.dir / f"wal_{seq}.log"

    def _complete_snapshots(self) -> list[int]:
        out = []
        for p in self.dir.glob("snapshot_*.json"):
            try:
                out.append(int(p.stem.split("_")[1]))
            except (IndexError, ValueError):
                continue
        return sorted(out)

    # --- recovery ------------------------------------------------------

    def recover(self, *, truncate: bool = True
                ) -> tuple[dict | None, list[dict]]:
        """Read the newest complete snapshot and its WAL tail.

        ``.tmp`` snapshot droppings are ignored (a crash mid-snapshot
        recovers from the previous snapshot + full log).  A torn final
        WAL record is truncated away (physically, when ``truncate`` —
        the engine's restart path; read-only for audits).  Positions
        the journal at the recovered segment so subsequent appends
        continue it.
        """
        snaps = self._complete_snapshots()
        snapshot = None
        if snaps:
            self.seq = snaps[-1]
            raw = self._snap_path(self.seq).read_text()
            try:
                snapshot = json.loads(raw)
            except json.JSONDecodeError as e:
                raise JournalError(
                    f"{self._snap_path(self.seq)}: unparseable "
                    f"snapshot: {e}") from e
        tail: list[dict] = []
        wal = self._wal_path(self.seq)
        if wal.exists():
            data = wal.read_bytes()
            tail, valid = read_frames(data, where=str(wal))
            if valid < len(data):
                self.torn_tail_truncated += 1
                if truncate:
                    with open(wal, "r+b") as fh:
                        fh.truncate(valid)
                        fh.flush()
                        os.fsync(fh.fileno())
        return snapshot, tail

    # --- appends -------------------------------------------------------

    _OPEN_FLAGS = os.O_WRONLY | os.O_CREAT | os.O_APPEND

    def _wal_open(self) -> int:
        if self._wal_fd is None:
            self._wal_fd = os.open(self._wal_path(self.seq),
                                   self._OPEN_FLAGS, 0o644)
        return self._wal_fd

    def append(self, record: dict) -> None:
        """Buffered append; durable only after the next :meth:`sync`."""
        self._wal_buf += _frame(_canon(record))
        self.records_appended += 1

    def sync(self) -> None:
        if self._wal_buf:
            fd = self._wal_open()
            os.write(fd, bytes(self._wal_buf))
            self._wal_buf.clear()
            os.fsync(fd)
            self.syncs += 1

    def ledger_append(self, record: dict) -> None:
        """Buffer a record for the never-truncated terminal ledger.
        Call only after the matching WAL terminal is durable
        (:meth:`sync`), so the ledger can never run ahead of the WAL —
        the exactly-once argument depends on that order."""
        self._ledger_buf += _frame(_canon(record))

    def ledger_sync(self) -> None:
        if self._ledger_buf:
            if self._ledger_fd is None:
                self._ledger_fd = os.open(self.dir / self.LEDGER,
                                          self._OPEN_FLAGS, 0o644)
            os.write(self._ledger_fd, bytes(self._ledger_buf))
            self._ledger_buf.clear()
            os.fsync(self._ledger_fd)

    # --- snapshots -----------------------------------------------------

    def snapshot(self, state: dict, *,
                 crash_point: Callable[[], None] | None = None) -> int:
        """Write a snapshot and rotate the WAL; returns the new seq.

        Protocol: write ``snapshot_<seq+1>.json.tmp`` + fsync, consult
        ``crash_point`` (the ``p_crash_mid_snapshot`` injection site —
        a crash here leaves only the ``.tmp``, which recovery ignores),
        rename to ``snapshot_<seq+1>.json``, fsync the directory, open
        the new WAL segment, then delete the superseded snapshot and
        segment.
        """
        self.sync()          # events up to here fold into the snapshot
        new = self.seq + 1
        tmp = self.dir / f"snapshot_{new}.json.tmp"
        with open(tmp, "w") as fh:
            fh.write(json.dumps(state, sort_keys=True,
                                separators=(",", ":")))
            fh.flush()
            os.fsync(fh.fileno())
        if crash_point is not None:
            crash_point()
        tmp.rename(self._snap_path(new))
        _fsync_dir(self.dir)
        if self._wal_fd is not None:
            os.close(self._wal_fd)
            self._wal_fd = None
        old = self.seq
        self.seq = new
        self._wal_open()
        for p in (self._snap_path(old), self._wal_path(old),
                  self.dir / f"snapshot_{old}.json.tmp"):
            try:
                p.unlink()
            except FileNotFoundError:
                pass
        self.snapshots_taken += 1
        return new

    def _close_fds(self) -> None:
        for fd in (self._wal_fd, self._ledger_fd):
            if fd is not None:
                os.close(fd)
        self._wal_fd = self._ledger_fd = None

    def close(self) -> None:
        self.sync()
        self.ledger_sync()
        self._close_fds()

    def abandon(self) -> None:
        """Simulated process death: drop every un-synced buffer and
        close the fds without writing — on-disk state is exactly what a
        ``kill -9`` at this instant would leave."""
        self._wal_buf.clear()
        self._ledger_buf.clear()
        self._close_fds()

    # --- audit ---------------------------------------------------------

    def read_ledger(self) -> list[dict]:
        """All terminal-ledger records (torn tail truncated in-read)."""
        path = self.dir / self.LEDGER
        if not path.exists():
            return []
        records, _ = read_frames(path.read_bytes(), where=str(path))
        return records

    def load_state(self) -> RecoveredState:
        """Read-only snapshot+tail replay (the audit entry point)."""
        snapshot, tail = self.recover(truncate=False)
        return replay(snapshot, tail)
