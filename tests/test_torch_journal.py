"""The port's request journal against the JAX package's.

The same requests through a journaled JAX engine (``ref`` ops) and a
journaled port engine (plain versions), both on the virtual clock, must
leave the same bytes on disk: every WAL segment, the terminal ledger and
every snapshot (the JAX package's ``_canon`` JSON in its CRC frames).
A journal directory that one package wrote after an induced crash is
recovered by the other, in both directions, and the run ends exactly as
a recovery in the writing package would.  Every comparison is exact."""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import repro.core  # noqa: F401  (the JAX package loads core before engine)
from repro.engine import SNNEnginePlan as JPlan
from repro.loadgen.runner import make_clock as jmake_clock
from repro.loadgen.runner import run_rows as jrun_rows
from repro.loadgen.workload import WorkloadSpec as JWorkload
from repro.serving import FaultInjector as JInjector
from repro.serving import FaultSpec as JSpec
from repro.serving import SNNRequest as JRequest
from repro.serving import SNNServingEngine as JServing
from repro.serving.journal import read_frames as jread_frames
from repro.serving.journal import replay as jreplay
from repro_torch.engine import SNNEnginePlan
from repro_torch.loadgen.runner import make_clock, run_rows
from repro_torch.loadgen.workload import WorkloadSpec
from repro_torch.serving import (FaultInjector, FaultSpec, JournalError,
                                 RequestJournal, RingLog, SNNRequest,
                                 SNNServingEngine, replay)
from repro_torch.serving.journal import _COUNTER_KEYS, read_frames

REPO = Path(__file__).resolve().parents[1]
ENV = dict(os.environ, PYTHONPATH=str(REPO / "src"), JAX_PLATFORMS="cpu")
N, W = 20, 4
PARAMS = dict(threshold=40, leak=3, w_exp=None, max_batch=3)
CRASH_POINTS = {"crash_before_dispatch": "p_crash_before_dispatch",
                "crash_after_serve": "p_crash_after_serve_before_journal",
                "crash_mid_snapshot": "p_crash_mid_snapshot"}


class SimCrash(Exception):
    """Stands in for process death in in-process crash tests."""


def _bank():
    return np.random.default_rng(0).integers(0, 2**32, (N, W),
                                             dtype=np.uint32)


def _engine(pkg, jdir, *, crash=None, encode="kernel", **kw):
    """A journaled engine of one package on a virtual clock; ``crash``
    arms one crash point (its hook raises :class:`SimCrash`)."""
    hook = None
    if crash is not None:
        spec = {CRASH_POINTS[crash]: 1.0}

        def die(kind):
            raise SimCrash(kind)
        hook = (JInjector(JSpec(**spec), crash_hook=die) if pkg == "jax"
                else FaultInjector(FaultSpec(**spec), crash_hook=die))
    plan = dict(encode=encode, **PARAMS)
    if pkg == "jax":
        import jax.numpy as jnp
        return JServing(jnp.asarray(_bank()), JPlan(**plan),
                        journal_dir=str(jdir), on_launch=hook,
                        clock=jmake_clock("virtual"), **kw)
    return SNNServingEngine(_bank(), SNNEnginePlan(kernel_backend="ref",
                                                   **plan),
                            journal_dir=str(jdir), on_launch=hook,
                            clock=make_clock("virtual"), device="cpu", **kw)


def _requests(pkg, n, rid0=0):
    cls = JRequest if pkg == "jax" else SNNRequest
    out = []
    for rid in range(rid0, rid0 + n):
        rng = np.random.default_rng(300 + rid)
        if rid % 4 == 3:       # an inline pre-packed window
            out.append(cls(rid=rid, window=rng.integers(
                0, 2**32, (5 + rid % 7, W), dtype=np.uint32),
                priority=rid % 2))
        else:
            out.append(cls(rid=rid, intensities=rng.integers(
                0, 256, (70,), dtype=np.uint8), n_steps=4 + rid % 9,
                deadline_ms=None if rid % 5 else 0.5))
    return out


def _drive(eng, reqs, gap=0.4):
    """Submit on a virtual timeline (one arrival each ``gap`` ms), step
    whenever the queue holds a batch's worth, then drain."""
    for r in reqs:
        eng.clock.skip_to(r.rid * gap)
        eng.submit(r)
        if len(eng.queue) >= 3:
            eng.step()
    while eng.queue:
        eng.step()


def _files(jdir: Path) -> dict[str, bytes]:
    return {p.name: p.read_bytes() for p in sorted(jdir.iterdir())}


# --- frames, replay, the ring ----------------------------------------------

def test_frames_and_replay_equal_jax(tmp_path):
    j = RequestJournal(tmp_path)
    recs = [{"ev": "A", "rid": 0, "ts": 0.5, "prio": 1, "ddl": None},
            {"ev": "D", "step": 0, "n": 1, "pad": 2, "ver": 0,
             "rids": [0], "at": 0.5},
            {"ev": "T", "rid": 0, "st": "SERVED", "at": 0.9, "ver": 0,
             "qw": 0.0, "sv": 0.4}]
    for r in recs:
        j.append(r)
    j.sync()
    j.close()
    data = (tmp_path / "wal_0.log").read_bytes()
    for torn in (data, data[:-3], data[:5], data + b"\x01\x02"):
        assert read_frames(torn) == jread_frames(torn)
    bad = bytearray(data)
    bad[10] ^= 0xFF
    with pytest.raises(JournalError):
        read_frames(bytes(bad))
    got, want = replay(None, recs), jreplay(None, recs)
    assert got.__dict__ == want.__dict__
    assert set(_COUNTER_KEYS) >= {"refresh_runs", "shed_codel",
                                  "retries_denied"}
    ring = RingLog(cap=4, items=range(10))
    assert list(ring) == [6, 7, 8, 9] and ring.dropped == 6


@pytest.mark.parametrize("encode", ["kernel", "host"])
def test_journal_bytes_equal_jax(tmp_path, encode):
    """WAL, ledger and snapshots of the same run, byte for byte."""
    engines = {}
    for pkg in ("jax", "port"):
        eng = _engine(pkg, tmp_path / pkg, encode=encode, snapshot_every=2)
        _drive(eng, _requests(pkg, 17))
        eng.close()
        engines[pkg] = eng
    jfiles, tfiles = _files(tmp_path / "jax"), _files(tmp_path / "port")
    assert sorted(tfiles) == sorted(jfiles)
    assert {"ledger.log"} < set(tfiles)
    assert any(n.startswith("snapshot_") for n in tfiles)
    for name in jfiles:
        assert tfiles[name] == jfiles[name], name
    js, ts = engines["jax"].stats(), engines["port"].stats()
    for k in ("mean_step_ms", "last_step_ms"):
        js.pop(k), ts.pop(k)
    assert ts == js and ts["journal_snapshots"] > 2


@pytest.mark.parametrize("crash", sorted(CRASH_POINTS))
@pytest.mark.parametrize("writer,reader", [("jax", "port"),
                                           ("port", "jax")])
def test_recovery_across_packages(tmp_path, crash, writer, reader):
    """One package crashes at a crash point (its un-synced buffers
    dropped, as ``kill -9`` would); the other recovers the directory and
    finishes the run.  The journal it leaves equals the one a recovery
    in the writing package leaves, and the ledger holds every rid once."""
    outcome = {}
    for finisher in (writer, reader):
        jdir = tmp_path / f"{finisher}"
        eng = _engine(writer, jdir, crash=crash, snapshot_every=1)
        with pytest.raises(SimCrash):
            _drive(eng, _requests(writer, 9))
        eng.journal.abandon()
        eng2 = _engine(finisher, jdir, snapshot_every=1)
        assert eng2.journal_recovered == len(eng2.queue)
        offset = eng2.journal_resume_offset
        _drive(eng2, _requests(finisher, 12 - offset, rid0=offset))
        eng2.close()
        outcome[finisher] = (_files(jdir), eng2.per_status(),
                             eng2.service_hist.to_dict())
        ledger = RequestJournal(jdir).read_ledger()
        rids = sorted(r["rid"] for r in ledger)
        assert rids == list(range(12)), rids
    assert outcome[reader] == outcome[writer]


def test_trace_rows_rematerialize_and_resume_like_jax(tmp_path):
    """A trace-backed run killed after 10 rows, resumed from the
    journaled offset: the same ledger and report in both packages."""
    rows = [WorkloadSpec(n_inputs=W * 32, seed=3).sample_row(i, i * 0.5)
            for i in range(30)]
    reports = {}
    for pkg, spec, run in (("jax", JWorkload(n_inputs=W * 32, seed=3),
                            jrun_rows),
                           ("port", WorkloadSpec(n_inputs=W * 32, seed=3),
                            run_rows)):
        jdir = tmp_path / pkg
        eng = _engine(pkg, jdir)
        run(eng, spec, rows[:10], verify_payloads=True)
        eng.journal.abandon()
        eng2 = _engine(pkg, jdir)
        assert eng2.journal_resume_offset == 10
        rep = run(eng2, spec, rows, resume_offset=10)
        eng2.close()
        reports[pkg] = (rep.to_dict(), _files(jdir))
    assert reports["port"] == reports["jax"]
    ledger = RequestJournal(tmp_path / "port").read_ledger()
    assert sorted(r["rid"] for r in ledger) == list(range(30))


def test_midlog_corruption_fails_loudly_at_construction(tmp_path):
    eng = _engine("port", tmp_path / "j", snapshot_every=0)
    _drive(eng, _requests("port", 6))
    eng.journal.sync()
    eng.journal.abandon()
    wal = next((tmp_path / "j").glob("wal_*.log"))
    data = bytearray(wal.read_bytes())
    data[12] ^= 0x40
    wal.write_bytes(bytes(data))
    with pytest.raises(JournalError, match="mid-log"):
        _engine("port", tmp_path / "j")
    with pytest.raises(Exception, match="mid-log"):
        _engine("jax", tmp_path / "j")


def test_newer_schema_counters_ride_through_recovery(tmp_path):
    """A snapshot counter the port does not know is kept and written
    back through its own snapshots (as the JAX engine does)."""
    eng = _engine("port", tmp_path / "j", snapshot_every=1)
    _drive(eng, _requests("port", 4))
    eng.close()
    snap = max((tmp_path / "j").glob("snapshot_*.json"))
    import json
    state = json.loads(snap.read_text())
    state["counters"]["from_the_future"] = 7
    snap.write_text(json.dumps(state))
    eng2 = _engine("port", tmp_path / "j")
    assert eng2._foreign_counters == {"from_the_future": 7}
    eng2.close()
    snap = max((tmp_path / "j").glob("snapshot_*.json"))
    assert json.loads(snap.read_text())["counters"]["from_the_future"] == 7
    jeng = _engine("jax", tmp_path / "j")
    assert jeng.per_status() == eng2.per_status()
    assert jeng._foreign_counters == {"from_the_future": 7}


def test_chaos_harness_on_a_small_trace(tmp_path):
    """``serve --chaos`` on the CPU: a generated 1,200-request trace,
    2 induced crashes (``os._exit(73)`` in a child), restart-resume,
    and the exactly-once audit against a crash-free replay."""
    trace = tmp_path / "small.json"
    rec = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.loadgen", "--record",
         str(trace), "--compact", "--n", "1200", "--rate", "20000",
         "--device", "cpu"],
        capture_output=True, text=True, env=ENV, timeout=120, cwd=REPO)
    assert rec.returncode == 0, rec.stderr
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
         "wenquxing-snn", "--chaos", "--chaos-crashes", "2", "--trace",
         str(trace), "--state-dir", str(tmp_path / "chaos"), "--device",
         "cpu"], capture_output=True, text=True, env=ENV, timeout=300,
        cwd=REPO)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    assert "chaos: trace complete after 2 induced crashes" in proc.stdout
    assert "chaos-audit: ok" in proc.stdout
    ledger = RequestJournal(tmp_path / "chaos" / "journal").read_ledger()
    assert sorted(r["rid"] for r in ledger) == list(range(1200))
