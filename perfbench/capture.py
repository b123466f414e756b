"""The program's logits at a seeded share of the served positions.

Installed on the window's engine in every run, from outside the
program: it wraps the model's ``prefill`` and ``decode_step`` and, for
each served position it keeps, copies that row of the logits the call
returned (float32, as the model gives them) to the host, before the
engine samples from them.  Position ``p`` of request ``rid`` (``p`` = 0:
the token of the admission's prefill) is kept where ``u64(seed, 6, rid,
p) % keep_every == 0``, in every slot.  The engine admits requests in
the order they were submitted, so the k-th prefill is the k-th request
sent (its prompt length is checked).  The check
(:mod:`perfbench.checks`) compares the rows kept for the sampled
requests with the reference's.
"""

from __future__ import annotations

import torch

from perfbench.traffic import u64


class Capture:
    def __init__(self, seed: int, keep_every: int):
        self.seed = seed % (1 << 64)
        self.keep_every = keep_every
        self.sent: list[tuple[int, int]] = []      # (rid, prompt length)
        self.rows: dict[tuple[int, int], torch.Tensor] = {}
        self._prefills = 0
        self._undo: list = []

    def kept(self, rid: int, pos: int) -> bool:
        return u64(self.seed, 6, rid, pos) % self.keep_every == 0

    def install(self, engine) -> None:
        model = engine.model

        def prefill(orig):
            def run(tokens, *args, **kwargs):
                logits, cache, clen = orig(tokens, *args, **kwargs)
                rid, n = self.sent[self._prefills]
                self._prefills += 1
                if n != tokens.shape[-1]:
                    raise RuntimeError(f"prefill {self._prefills - 1} took "
                                       f"{tokens.shape[-1]} tokens; request "
                                       f"{rid} has {n}")
                if self.kept(rid, 0):
                    self.rows[(rid, 0)] = logits[0].cpu()
                return logits, cache, clen
            return run

        def decode(orig):
            def run(*args, **kwargs):
                want = [(i, r.rid, len(r.output))
                        for i, r in enumerate(engine.slot_req)
                        if r is not None and self.kept(r.rid, len(r.output))]
                logits, cache = orig(*args, **kwargs)
                if want:
                    rows = logits[[i for i, _, _ in want]].cpu()
                    for (_, rid, pos), row in zip(want, rows):
                        self.rows[(rid, pos)] = row
                return logits, cache
            return run

        for name, wrap in (("prefill", prefill), ("decode_step", decode)):
            orig = getattr(model, name)
            self._undo.append((model, name))
            setattr(model, name, wrap(orig))

    def uninstall(self) -> None:
        for owner, name in reversed(self._undo):
            delattr(owner, name)
        self._undo.clear()

    def of(self, rid: int) -> dict[int, torch.Tensor]:
        """pos -> logits row, for one request."""
        return {p: row for (r, p), row in self.rows.items() if r == rid}
