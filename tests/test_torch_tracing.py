"""The port's spans (``repro_torch.runtime.tracing``) and the serving
engine's request stamps, on the CPU.

With no profiler session a span is one shared no-op: no profiler
range, no event, nothing stored.  Under a session each
span is stored with its parent and shows on the profiler's timeline
under its name, inside the host interval the store gives it; the LM's
decode step and attention layers, and the training step's phases, open
theirs; greedy outputs do not change.  ``t_submit`` and ``t_admit``
bracket a request's wait in the engine's queue.
"""

import contextlib
import time

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch.configs.base import get_config, reduced
from repro_torch.data import SyntheticTokens
from repro_torch.launch.train import make_train_step
from repro_torch.models.transformer import Model
from repro_torch.optim import AdamW, AdamWConfig
from repro_torch.runtime import tracing
from repro_torch.serving import Request, ServingEngine


@pytest.fixture(autouse=True)
def empty_store():
    tracing.clear()
    yield
    tracing.clear()


def _session():
    return profile(activities=[ProfilerActivity.CPU])


def _moe_engine(n_slots=2):
    model = Model(reduced(get_config("mixtral-8x22b")), torch.float32,
                  attn_chunk=16, device="cpu", seed=3)
    return model, ServingEngine(model, n_slots=n_slots, max_len=48)


def _requests():
    return [Request(rid=i, prompt=[3 + i, 7, 11 + 2 * i][: 1 + i % 3],
                    max_new_tokens=5) for i in range(4)]


def test_span_is_a_shared_noop_without_a_session(monkeypatch):
    def refuse(*_a, **_k):
        raise AssertionError("entered while no session records")

    monkeypatch.setattr(tracing, "_Range", refuse)
    monkeypatch.setattr(torch.cuda, "Event", refuse)
    monkeypatch.setattr(time, "perf_counter_ns", refuse)
    got = {id(tracing.span(n, device=d))
           for n in ("model/decode", "attn/decode") for d in (False, True)}
    assert len(got) == 1
    with tracing.span("model/decode"):
        with tracing.span("attn/decode", device=True):
            pass
    assert tracing.records("model/decode") == []
    assert tracing.records("attn/decode") == []


def _clock_offset_ns() -> int:
    """time.time_ns() - time.perf_counter_ns() (the profiler's host
    events are on the wall clock), from the narrowest of 20 brackets."""
    best = None
    for _ in range(20):
        a = time.perf_counter_ns()
        w = time.time_ns()
        b = time.perf_counter_ns()
        if best is None or b - a < best[0]:
            best = (b - a, w - (a + b) // 2)
    return best[1]


def test_spans_under_a_session_have_parents_and_sit_on_the_timeline():
    with _session() as prof:
        with tracing.span("t/outer"):
            for _ in range(2):
                with tracing.span("t/inner", device=True):
                    time.sleep(0.002)
                    torch.ones(64).sum()
    offset = _clock_offset_ns()
    outer, = tracing.records("t/outer")
    inner = tracing.records("t/inner")
    assert outer.parent is None and len(inner) == 2
    assert all(r.parent == "t/outer" for r in inner)
    assert all(r.device_ms is None for r in inner + [outer])
    assert all(outer.t0_ns <= r.t0_ns < r.t1_ns <= outer.t1_ns
               for r in inner)
    assert all(r.host_ms >= 2.0 for r in inner)
    assert outer.host_ms == pytest.approx((outer.t1_ns - outer.t0_ns) * 1e-6)
    # the clocks are read apart: the profiler's interval must sit inside
    # the store's to within 0.2 ms (each inner span lasts over 2 ms)
    slack = 200_000
    events = {}
    for e in prof.profiler.kineto_results.events():
        events.setdefault(e.name(), []).append(
            (e.start_ns() - offset, e.start_ns() + e.duration_ns() - offset))
    for name, stored in (("t/outer", [outer]), ("t/inner", inner)):
        seen = sorted(events.get(name, []))
        assert len(seen) == len(stored), name
        for (t0, t1), r in zip(seen, stored):
            assert r.t0_ns - slack <= t0 <= t1 <= r.t1_ns + slack, name


def test_engine_outputs_equal_with_the_session_on_and_off():
    outputs = []
    for on in (False, True):
        model, eng = _moe_engine()
        reqs = _requests()
        if on:
            with _session():
                eng.run(reqs, max_steps=100)
        else:
            eng.run(reqs, max_steps=100)
        assert all(r.done for r in reqs)
        outputs.append([r.output for r in reqs])
    assert outputs[0] == outputs[1]
    steps = tracing.records("model/decode")
    attn = tracing.records("attn/decode")
    assert len(steps) == eng.steps > 0
    assert len(attn) == model.cfg.n_layers * len(steps)
    assert all(r.parent == "model/decode" and r.device_ms is None
               and r.host_ms > 0 for r in attn)


def test_training_step_phases_are_spans():
    cfg = reduced(get_config("gemma3-1b"))
    model = Model(cfg, torch.float32, device="cpu", seed=0)
    opt = AdamW(AdamWConfig(lr=1e-3))
    step = make_train_step(model, opt)
    params = dict(model.named_parameters())
    batch = {k: torch.from_numpy(v) for k, v in SyntheticTokens(
        vocab_size=cfg.vocab_size, seq_len=16, batch_size=2,
        seed=3).batch(0).items()}
    step(params, opt.init(params), batch)
    assert tracing.records("train/forward") == []
    with _session():
        step(params, opt.init(params), batch)
    for name in ("train/forward", "train/backward", "train/optimizer"):
        got, = tracing.records(name)
        assert got.parent is None and got.host_ms > 0, name


@pytest.mark.parametrize("traced", [False, True])
def test_requests_are_stamped_at_submit_and_admission(traced):
    _, eng = _moe_engine(n_slots=2)
    reqs = _requests()
    before = time.perf_counter()
    for r in reqs:
        eng.submit(r)
    submitted = time.perf_counter()
    assert all(r.t_admit is None for r in reqs)
    admitted = []          # (step's call, its return, requests it took)
    with _session() if traced else contextlib.nullcontext():
        while not all(r.done for r in reqs):
            waiting = [r for r in reqs if r.t_admit is None]
            called = time.perf_counter()
            eng.step()
            admitted.append((called, time.perf_counter(),
                             [r for r in waiting if r.t_admit is not None]))
    assert sorted(r.rid for *_, took in admitted for r in took) == \
        [r.rid for r in reqs]
    for called, returned, took in admitted:
        for r in took:
            assert before <= r.t_submit <= submitted <= called \
                <= r.t_admit <= returned
    # two slots: the last two requests wait for the first two to finish
    assert len(admitted[0][2]) == 2
    assert min(r.t_admit for r in reqs[2:]) > admitted[0][1]
    assert (len(tracing.records("model/decode")) > 0) == traced
