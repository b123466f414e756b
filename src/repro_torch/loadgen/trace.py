"""Replayable load traces: record a generated request stream, replay it
bit-identically against any commit.

A trace is a JSONL file.  Line 1 is the **header** — trace version,
the :class:`~repro_torch.loadgen.arrivals.ArrivalSpec` and
:class:`~repro_torch.loadgen.workload.WorkloadSpec` that generated the
stream, the request count, and a SHA-256 **stream digest** over the
canonical serialization of every request row.  Two densities share
that header:

* ``kind="full"`` — one JSON row per request follows (ids, virtual
  timestamps, sampled fields, payload seed + content hash; payload
  *bytes* are never stored — they regenerate from the seed).
* ``kind="compact"`` — no rows follow.  Because sampling is stateless
  and seeded, the stream is fully derivable from the header's specs;
  :func:`read_trace` regenerates it and verifies the stream digest, so
  a multi-megabyte 50k-request stream commits as a few hundred bytes
  while remaining pinned bit-for-bit.  Tampering with the header specs
  or regenerating with drifted sampling code fails the digest check
  (:class:`TraceError`), never silently replays different traffic.

Either way, ``read_trace`` hands back ``(header, rows)`` where the
rows are exactly what the recorder produced: same ids, same seeds,
same timestamps, same payload hashes.
"""

from __future__ import annotations

import hashlib
import json

from repro_torch.loadgen.arrivals import ArrivalSpec, timestamps
from repro_torch.loadgen.workload import WorkloadSpec

TRACE_VERSION = 1


class TraceError(ValueError):
    """A trace failed structural or digest verification."""


def _canon(obj) -> str:
    return json.dumps(obj, sort_keys=True, separators=(",", ":"))


def stream_sha(rows: list[dict]) -> str:
    """SHA-256 over the canonical serialization of the row stream."""
    h = hashlib.sha256()
    for row in rows:
        h.update(_canon(row).encode())
        h.update(b"\n")
    return h.hexdigest()


def generate_rows(arrivals: ArrivalSpec,
                  workload: WorkloadSpec) -> list[dict]:
    """Sample the full request stream the two specs define."""
    return [workload.sample_row(rid, ts)
            for rid, ts in enumerate(timestamps(arrivals))]


def make_header(arrivals: ArrivalSpec, workload: WorkloadSpec,
                rows: list[dict], *, kind: str) -> dict:
    return {
        "version": TRACE_VERSION,
        "kind": kind,
        "n_requests": len(rows),
        "stream_sha256": stream_sha(rows),
        "arrivals": arrivals.to_dict(),
        "workload": workload.to_dict(),
    }


def write_trace(path: str, arrivals: ArrivalSpec, workload: WorkloadSpec,
                rows: list[dict] | None = None, *,
                compact: bool = False) -> dict:
    """Record a trace (generating the rows if not given); returns the
    header.  ``compact=True`` writes the header only — the stream stays
    pinned by its digest and regenerates on read."""
    if rows is None:
        rows = generate_rows(arrivals, workload)
    header = make_header(arrivals, workload, rows,
                         kind="compact" if compact else "full")
    with open(path, "w") as fh:
        fh.write(_canon(header) + "\n")
        if not compact:
            for row in rows:
                fh.write(_canon(row) + "\n")
    return header


def read_trace(path: str) -> tuple[dict, list[dict]]:
    """Load (and for compact traces, regenerate) a trace; verifies the
    stream digest either way.  Raises :class:`TraceError` on any
    mismatch — a trace that fails verification must never be served."""
    with open(path) as fh:
        lines = [ln for ln in fh.read().splitlines() if ln.strip()]
    if not lines:
        raise TraceError(f"{path}: empty trace file")
    try:
        header = json.loads(lines[0])
    except json.JSONDecodeError as e:
        raise TraceError(f"{path}: unparseable header: {e}") from e
    if header.get("version") != TRACE_VERSION:
        raise TraceError(f"{path}: unsupported trace version "
                         f"{header.get('version')!r}")
    arrivals = ArrivalSpec.from_dict(header["arrivals"])
    workload = WorkloadSpec.from_dict(header["workload"])
    if header.get("kind") == "compact":
        rows = generate_rows(arrivals, workload)
    else:
        try:
            rows = [json.loads(ln) for ln in lines[1:]]
        except json.JSONDecodeError as e:
            raise TraceError(f"{path}: unparseable row: {e}") from e
    if len(rows) != header["n_requests"]:
        raise TraceError(
            f"{path}: header says {header['n_requests']} requests, "
            f"got {len(rows)} rows")
    digest = stream_sha(rows)
    if digest != header["stream_sha256"]:
        raise TraceError(
            f"{path}: stream digest mismatch — recorded "
            f"{header['stream_sha256'][:12]}…, got {digest[:12]}… "
            f"(tampered rows, or sampling drift vs the recording "
            f"commit)")
    return header, rows


def scale_rows(rows: list[dict], factor: float) -> list[dict]:
    """Time-compress a recorded stream: divide every intended arrival
    by ``factor``, multiplying the offered rate (factor=5 turns a 1x
    trace into the same requests at 5x).  Payload content hashes are
    unaffected — ``payload_sha`` covers the sampled fields and seed,
    not the timestamp — so a scaled stream still verifies per-row."""
    if factor <= 0:
        raise ValueError(f"factor must be > 0, got {factor}")
    return [{**row, "ts": round(row["ts"] / factor, 3)} for row in rows]


def verify_payloads(workload: WorkloadSpec, rows: list[dict]) -> int:
    """Re-derive every row's payload and check its content hash;
    returns the number of rows checked (raises on the first
    mismatch)."""
    for row in rows:
        if workload.payload_sha(row) != row["sha"]:
            raise TraceError(
                f"row {row['rid']}: payload hash mismatch "
                f"(recorded {row['sha']}, regenerated "
                f"{workload.payload_sha(row)})")
    return len(rows)
