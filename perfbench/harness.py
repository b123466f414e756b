"""One run of one cell: set-up, the measured window, the check, the line.

Everything a cell is made of is found by name: its entry in
``BENCHMARK.json``, ``configs/<config>.json`` (through the entry's
``file``), ``traffic/<traffic>.json``, ``cells/<cell>.json`` (the
sample the check draws and the limits of its numbers) and
``metrics/<metric>.py`` for every metric the cell reports.  Nothing here
knows a cell.

The engine is the port's ``ServingEngine`` over its ``Model``, built
with ``seed=None`` and filled by :mod:`perfbench.weights`.  The window
drives it: an open loop submits, before each ``step()``, every request
whose due time has passed; a closed loop submits a client's next request
when the step that finished its last one returns.  Every token is
stamped with the host clock when the step that produced it returns (the
step ends in a copy to the host, so the card is done).  The window
closes at the end of the first step that ends ``--seconds`` after it
opened; the loop then goes on, arrivals and all, until every request
sent in the window has its first token and ``finished_min`` requests
have finished (at most ``drain_s`` longer), so that the check has its
sample.
"""

from __future__ import annotations

import dataclasses
import gc
import importlib.util
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

from perfbench import checks, sizes, traffic, weights
from perfbench.capture import Capture
from perfbench.spans import Spans
from perfbench.trace import read as read_trace

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


@dataclasses.dataclass
class Cell:
    name: str
    entry: dict
    config: dict
    dims: sizes.Dims
    traffic: dict
    check: dict
    metrics: list[dict]        # end_to_end and per_layer entries for it


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def find(root: Path, cell: str) -> Cell:
    """The cell's entry and files under ``root`` (a checkout)."""
    doc = json.loads((root / "BENCHMARK.json").read_text())
    entry = next((w for w in doc["workloads"] if w["name"] == cell), None)
    if entry is None:
        raise KeyError(f"no workload {cell!r} in BENCHMARK.json")
    cfg_entry = next(c for c in doc["configs"] if c["name"] == entry["config"])
    config = sizes.load(root / cfg_entry["file"])
    data = root / "perfbench"
    return Cell(
        name=cell, entry=entry, config=config, dims=sizes.dims(config),
        traffic=traffic.load(data / "traffic" / f"{entry['traffic']}.json"),
        check=json.loads((data / "cells" / f"{cell}.json").read_text()),
        metrics=[dict(m, kind=kind) for kind in ("end_to_end", "per_layer")
                 for m in doc[kind] if _reports(m, cell)])


def reader(root: Path, name: str):
    """``metrics/<name>.py``'s ``read``."""
    path = root / "perfbench" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"pb_metric_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


# --- the program ---------------------------------------------------------------


def build_model(cell: Cell, seed: int, device):
    """The port's ``Model`` for the cell's configuration, its weights
    drawn from the seed."""
    from repro_torch.configs.base import get_config
    from repro_torch.models.transformer import Model

    port = dict(cell.config["port"])
    arch = dataclasses.replace(get_config(port.pop("arch")), **port)
    d = cell.dims
    told = {"d_model": arch.d_model, "d_ff": arch.d_ff,
            "n_layers": arch.n_layers, "n_heads": arch.n_heads,
            "n_kv_heads": arch.n_kv_heads, "head_dim": arch.hd,
            "n_experts": arch.n_experts, "top_k": arch.top_k,
            "vocab": arch.vocab_padded, "rope_theta": arch.rope_theta,
            "window": arch.window,
            "capacity_factor": arch.capacity_factor}
    wrong = {k: (v, getattr(d, k)) for k, v in told.items()
             if v != getattr(d, k)}
    if wrong or arch.vocab_size != d.vocab or arch.moe_period != 1:
        raise ValueError(f"the port's config departs from the file: {wrong}")
    model = Model(arch, torch.bfloat16, device=device, seed=None)
    weights.load_into(model, d, seed)
    return model


def engine_for(model, params: dict):
    from repro_torch.serving.engine import ServingEngine

    return ServingEngine(model, n_slots=params["n_slots"],
                         max_len=params["max_len"], temperature=0.0)


def warm_up(model, params: dict, tr: traffic.Traffic) -> None:
    """The cell's shapes once: a prefill of the mix's longest prompt, a
    short one, and decode steps (every step decodes all the slots)."""
    from repro_torch.serving.engine import Request

    eng = engine_for(model, params)
    for i, n in enumerate((tr.longest_prompt(), 8)):
        eng.submit(Request(rid=-1 - i, prompt=[1] * n, max_new_tokens=3))
    while any(r is not None for r in eng.slot_req) or eng.queue:
        eng.step()
    _sync(model.device)


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def _profiler():
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    return profile(activities=acts)


def warm_profiler(device) -> None:
    """A first profiler session that records the card's work, before
    the window (a first session has been seen to record none)."""
    if torch.device(device).type != "cuda":
        return
    x = torch.ones((256, 256), device=device)
    for _ in range(3):
        prof = _profiler()
        prof.start()
        for _ in range(4):
            x = x @ x * 0.001
        torch.cuda.synchronize(device)
        prof.stop()
        if read_trace(prof, 1.0).busy_s > 0:
            return
        time.sleep(0.5)


# --- the window ----------------------------------------------------------------


@dataclasses.dataclass
class Flight:
    spec: traffic.Spec
    req: object
    t_due: float               # open loop: due; closed: sent
    times: list[float]
    slot: int = -1


@dataclasses.dataclass
class Log:
    flights: list[Flight]
    t0: float
    t_close: float
    t_end: float
    seconds: float
    steps: int
    lateness: list[float]
    trace: object = None
    calls: dict | None = None


def drive(engine, tr: traffic.Traffic, params: dict, seconds: float,
          spans: Spans | None = None, capture: Capture | None = None,
          clock=time.perf_counter) -> Log:
    from repro_torch.serving.engine import Request

    flights: list[Flight] = []
    live: list[Flight] = []
    late: list[float] = []
    count = 0

    def send(now: float, due: float) -> None:
        nonlocal count
        spec = tr.request(count)
        count += 1
        req = Request(rid=spec.index, prompt=spec.tokens,
                      max_new_tokens=spec.max_new_tokens)
        engine.submit(req)
        if capture is not None:
            capture.sent.append((spec.index, len(spec.tokens)))
        f = Flight(spec, req, due, [])
        flights.append(f)
        live.append(f)

    dev = engine.model.device
    slice_ = params.get("trace") if spans is not None else None
    prof, got, t_tr = None, None, 0.0

    def stop_trace():
        _sync(dev)
        window = clock() - t_tr
        spans.recording = False
        prof.stop()
        return prof, window
    t0 = clock()
    opened = t0 + seconds
    t_close = None
    drain_to = opened + params.get("drain_s", 60)
    finished_min = params.get("finished_min", 0)
    if not tr.open:
        for _ in range(params["clients"]):
            send(t0, t0)
    steps = 0
    while True:
        now = clock()
        if tr.open:
            while t0 + tr.due(count) <= now:
                due = t0 + tr.due(count)
                late.append(now - due)
                send(now, due)
        if slice_ and prof is None and got is None \
                and now >= t0 + slice_["start_s"]:
            _sync(dev)
            prof = _profiler()
            prof.start()
            spans.recording = True
            t_tr = clock()
        if prof is not None and now >= t_tr + slice_["seconds"]:
            got, prof = stop_trace(), None
        busy = engine.queue or any(r is not None for r in engine.slot_req)
        if busy:
            engine.step()
            steps += 1
        t = clock()
        finished = []
        for f in live:
            n = len(f.req.output)
            if n > len(f.times):
                if not f.times:
                    f.slot = f.req.slot
                f.times.extend([t] * (n - len(f.times)))
            if f.req.done:
                finished.append(f)
        for f in finished:
            live.remove(f)
            if not tr.open:
                send(t, t)
        if t_close is None and t >= opened:
            t_close = t
        if t_close is not None and (t >= drain_to or (
                all(f.times for f in flights if f.t_due < opened)
                and sum(f.req.done for f in flights) >= finished_min)):
            break
        if not busy:
            time.sleep(max(0.0, min(t0 + tr.due(count) - clock(), 0.01)))
    if prof is not None:
        got = stop_trace()
    log = Log(flights, t0, t_close, clock(), seconds, steps, late)
    if got is not None:
        log.trace = read_trace(*got)
        log.calls = spans.calls
    return log


# --- metrics -------------------------------------------------------------------


@dataclasses.dataclass
class Run:
    """What the metric readers read."""
    log: Log
    dims: sizes.Dims
    params: dict
    setup_s: float

    @property
    def trace(self):
        return self.log.trace

    @property
    def calls(self):
        return self.log.calls

    def sent_in_window(self) -> list[Flight]:
        lg = self.log
        return [f for f in lg.flights if lg.t0 <= f.t_due < lg.t0 + lg.seconds]

    def window_s(self) -> float:
        return self.log.t_close - self.log.t0

    def token_times(self) -> list[float]:
        lg = self.log
        return [t for f in lg.flights for t in f.times
                if lg.t0 < t <= lg.t_close]


def percentile(values, q: float):
    return float(np.percentile(np.asarray(values, dtype=np.float64), q)) \
        if len(values) else None


def measure(root: Path, cell: Cell, run: Run, kind: str) -> dict:
    units = {m["name"]: m["unit"] for m in cell.metrics}
    out = {}
    if kind == "per_layer" and run.trace is None:
        return out
    for m in cell.metrics:
        if m["kind"] != kind:
            continue
        value = reader(root, m["name"])(run)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": units[m["name"]]}
    return out


# --- the check -----------------------------------------------------------------


def verify(cell: Cell, log: Log, seed: int, device, capture: Capture,
           say=print, served=None, reference=checks.reference_logits
           ) -> tuple[bool, dict]:
    """Sample, reference, compare, judge (see :mod:`perfbench.checks`).
    ``served(flights) -> (tokens, rows)`` puts other outputs in
    the program's place (the control); by default the program's own:
    its served tokens and the logits rows ``capture`` kept."""
    window = [f for f in log.flights
              if log.t0 <= f.t_due < log.t0 + log.seconds]
    done = [f for f in log.flights if f.req.done]
    picked = checks.sample(done, cell.check["sample"], seed)
    refs = reference(cell.dims, seed, picked, device)
    if served is None:
        tokens = [f.req.output for f in picked]
        rows = [capture.of(f.spec.index) for f in picked]
    else:
        tokens, rows = served(picked)
    values = checks.compare(refs, tokens, rows)
    widest = values.pop("widest")
    say(f"check sample: {len(picked)} requests in slots "
        f"{sorted({f.slot for f in picked})}, {values['compared']} tokens, "
        f"{values['logits_compared']} logit rows; widest logit error "
        f"{widest['logit_err']}, widest gap {widest['gap']}")
    values.update(
        failed=sum(1 for f in window if not f.times),
        short=sum(1 for f in done
                  if len(f.req.output) != f.spec.max_new_tokens))
    return checks.judge(values, cell.check["limits"])


# --- one run -------------------------------------------------------------------


def card_info() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm,"
             "clocks.max.sm", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=20)
        return out.stdout.strip() or out.stderr.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi not available ({e})"


def forbidden_modules() -> list[str]:
    return sorted({name.split(".")[0] for name in sys.modules}
                  & set(FORBIDDEN))


def run(root: Path, name: str, seed: int, seconds: float, trace: bool,
        device, t_start: float, say=print) -> dict:
    """One run; returns the result line's object."""
    cell = find(root, name)
    params = cell.traffic
    on_card = torch.device(device).type == "cuda"
    if on_card:
        say(f"card: {card_info()}")
        torch.cuda.init()
        torch.cuda.reset_peak_memory_stats(device)
    tr = traffic.Traffic(params, seed, cell.dims.vocab, seconds)
    model = build_model(cell, seed, device)
    spans = Spans() if trace else None
    warm_up(model, params, tr)
    if trace:
        warm_profiler(device)
    engine = engine_for(model, params)
    capture = Capture(seed, cell.check["keep_every"])
    capture.install(engine)
    if spans is not None:
        spans.install(engine)
    setup_s = time.perf_counter() - t_start

    log = drive(engine, tr, params, seconds, spans, capture)

    peak = torch.cuda.max_memory_allocated(device) if on_card else 0
    if spans is not None:
        spans.uninstall()
    capture.uninstall()
    r = Run(log, cell.dims, params, setup_s)
    metrics = measure(root, cell, r, "per_layer" if trace else "end_to_end")
    window = r.sent_in_window()
    late = [x for f, x in zip(log.flights, log.lateness)
            if log.t0 <= f.t_due < log.t0 + seconds] if tr.open else []
    say(f"requests: {len(window)} sent in the window, "
        f"{sum(1 for f in window if f.req.done)} finished, "
        f"{sum(1 for f in log.flights if f.req.done)} finished in all; "
        f"{log.steps} engine steps; window {r.window_s()} s, "
        f"drained {log.t_end - log.t_close} s more")
    if tr.open:
        say(f"generator lateness: max {max(late, default=0.0)} s, mean "
            f"{float(np.mean(late)) if late else 0.0} s")
    say(f"memory peak: {peak} bytes; setup {setup_s} s")

    del engine, model
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    correct, shown = verify(cell, log, seed, device, capture, say)
    result = {
        "correct": correct,
        "attempted": len(window),
        "failed": shown.get("failed", {}).get("value", 0),
        "metrics": metrics,
        "device": {"platform": "gpu" if on_card else "cpu",
                   "kind": (torch.cuda.get_device_name(device) if on_card
                            else "cpu"),
                   "count": 1, "memory_peak_bytes": int(peak)},
    }
    if trace and log.trace is not None:
        result["device"].update(busy_s=log.trace.busy_s,
                                window_s=log.trace.window_s)
        result["breakdown"] = {"device_ops": log.trace.device_ops,
                               "idle_gaps": log.trace.idle_gaps}
    result["checks"] = shown
    for k, v in shown.items():
        print(f"check {k}: {v['value']} (limit {v['limit']})",
              file=sys.stderr)
    return result
