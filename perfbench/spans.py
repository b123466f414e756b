"""Spans around the port's layers, installed by the benchmark.

In a traced run, :func:`install` wraps the calls into each layer in
``torch.profiler.record_function`` ranges, from outside the program:

* ``pb.step``: ``ServingEngine.step`` (admission, decode, sampling);
* ``pb.prefill`` / ``pb.decode``: ``Model.prefill`` / ``decode_step``;
* ``pb.moe.forward``, ``pb.moe.route``, ``pb.moe.slots``,
  ``pb.moe.experts`` (``models/layers/moe.py``) and ``pb.flash``
  (the flash kernel's wrapper as ``models/layers/attention.py`` calls
  it), each named with the step it ran in: ``@prefill`` or ``@decode``.

While ``recording`` is on, the wrappers also keep what the counts need:
each prefill's prompt length, each decode step's live slots (the keys
each attends), each flash call's shape.  Nothing is read back from the
card.
"""

from __future__ import annotations

import contextlib
import functools

from torch.profiler import record_function


class Spans:
    def __init__(self):
        self.recording = False
        self.phase = "none"
        self.calls: dict[str, list] = {"prefill": [], "decode": [],
                                       "flash": []}
        self._undo: list = []

    def _patch(self, owner, name: str, wrap) -> None:
        orig = getattr(owner, name)
        self._undo.append((owner, name, owner.__dict__.get(name)))
        setattr(owner, name, functools.wraps(orig)(wrap(orig)))

    def _ranged(self, label: str):
        def wrap(orig):
            def run(*args, **kwargs):
                with record_function(f"pb.{label}@{self.phase}"):
                    return orig(*args, **kwargs)
            return run
        return wrap

    @contextlib.contextmanager
    def _in(self, phase: str, label: str):
        outer, self.phase = self.phase, phase
        try:
            with record_function(label):
                yield
        finally:
            self.phase = outer

    def install(self, engine) -> None:
        """Wrap ``engine``'s step, its model's prefill and decode, and the
        MoE and attention layers' module functions."""
        from repro_torch.models.layers import attention, moe

        model = engine.model

        def step(orig):
            def run():
                with record_function("pb.step"):
                    return orig()
            return run

        def prefill(orig):
            def run(tokens, *args, **kwargs):
                if self.recording:
                    self.calls["prefill"].append(int(tokens.shape[-1]))
                with self._in("prefill", "pb.prefill"):
                    return orig(tokens, *args, **kwargs)
            return run

        def decode(orig):
            def run(*args, **kwargs):
                if self.recording:
                    self.calls["decode"].append(
                        [int(engine.cache_len[i]) + 1
                         for i, r in enumerate(engine.slot_req)
                         if r is not None])
                with self._in("decode", "pb.decode"):
                    return orig(*args, **kwargs)
            return run

        def flash(orig):
            def run(q, k, v, *, causal=True, window=None, **kwargs):
                if self.recording:
                    b, hq, tq, d = q.shape
                    self.calls["flash"].append(
                        (b, hq, k.shape[1], d, tq, k.shape[2], causal,
                         window))
                with record_function(f"pb.flash@{self.phase}"):
                    return orig(q, k, v, causal=causal, window=window,
                                **kwargs)
            return run

        self._patch(engine, "step", step)
        self._patch(model, "prefill", prefill)
        self._patch(model, "decode_step", decode)
        for name in ("forward", "route", "slots", "experts"):
            self._patch(moe, name, self._ranged(f"moe.{name}"))
        self._patch(attention, "flash_attention", flash)

    def uninstall(self) -> None:
        for owner, name, orig in reversed(self._undo):
            if orig is None:
                delattr(owner, name)
            else:
                setattr(owner, name, orig)
        self._undo.clear()
