"""Requests of a traffic mix, from its data file and the run's seed.

One general generator reads every ``traffic/<name>.json``.  The file
holds parameters only:

* ``loop``: ``"open"`` (requests due on a schedule, whatever the server
  does: independent users) or ``"closed"`` (``clients`` callers, each
  sending its next request when its last one has finished);
* ``arrivals`` (open loop): ``{"process": "poisson", "rate_rps": r}``;
* ``prompt``, ``output``: token counts, ``{"dist": "lognormal",
  "median": m, "sigma": s, "min": a, "max": b}``, ``{"dist":
  "uniform", "min": a, "max": b}`` or ``{"dist": "fixed", "value": v}``;
* ``max_total``: prompt + output at most this (the output is cut);
* ``population_seed``: the seed of the population below, the same for
  every run; ``population`` (closed loop): its size;
* ``n_slots``, ``max_len``: the serving engine's decode slots and cache
  length; ``drain_s`` (open loop): how long past the window's close the
  requests due in it may take to give their first token;
* ``trace``: ``{"start_s": a, "seconds": b}``, the slice of the window
  that a ``--trace 1`` run profiles;
* ``source``: where the numbers come from (read by no code).

Every seed gets the same work in another order.  The requests come in
segments: an open loop's segment is the window (``round(rate x
seconds)`` requests), a closed loop's ``population`` requests.  Each
segment holds the same population, drawn once, i.i.d., from
``population_seed``: prompt lengths, output lengths and (open loop)
exponential gaps, the gaps scaled to sum to the segment's length; a
request's prompt and output lengths are drawn as a pair.  The run's
seed puts the pairs and the gaps each in an order of its own in each
segment, and draws the prompts' tokens (uniform over the vocabulary).
So an open loop's arrivals are a Poisson process held to its count in
the window, bursts at every scale below it, and every seed sends the
same requests in the window.  The counter hash is a copy of
``repro_torch.loadgen.arrivals.u64``.
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path

import numpy as np

_M64 = (1 << 64) - 1
_P1 = 0x9E3779B97F4A7C15
_P2 = 0xBF58476D1CE4E5B9
_P3 = 0x94D049BB133111EB


def u64(seed: int, *counters: int) -> int:
    """Stateless 64-bit draw for (seed, counters...): splitmix64's mixer
    over a Weyl combination of the counters."""
    z = (seed * _P1) & _M64
    for i, c in enumerate(counters):
        z = (z + (c + 1) * ((_P2 + 2 * i) & _M64)) & _M64
    z ^= z >> 30
    z = (z * _P2) & _M64
    z ^= z >> 27
    z = (z * _P3) & _M64
    return z ^ (z >> 31)


def load(path: Path) -> dict:
    params = json.loads(Path(path).read_text())
    if params["loop"] not in ("open", "closed"):
        raise ValueError(f"{path}: loop must be open or closed")
    return params


def lengths(dist: dict, n: int, rng: np.random.Generator) -> np.ndarray:
    """n i.i.d. token counts of a length distribution, as ints."""
    kind = dist["dist"]
    if kind == "fixed":
        vals = np.full(n, float(dist["value"]))
    elif kind == "uniform":
        vals = rng.integers(dist["min"], dist["max"], size=n,
                            endpoint=True).astype(np.float64)
    elif kind == "lognormal":
        vals = dist["median"] * np.exp(dist["sigma"]
                                       * rng.standard_normal(n))
    else:
        raise ValueError(f"unknown length distribution {kind!r}")
    lo, hi = dist.get("min", 1), dist.get("max", 1 << 30)
    return np.clip(np.rint(vals), lo, hi).astype(np.int64)


@dataclasses.dataclass(frozen=True)
class Spec:
    index: int
    tokens: list[int]
    max_new_tokens: int
    due_s: float          # open loop: offset from the window's start


class Traffic:
    """The request stream of one traffic mix under one seed, for a
    window of ``seconds``."""

    def __init__(self, params: dict, seed: int, vocab: int, seconds: float):
        self.params = params
        self.seed = seed % (1 << 64)
        self.vocab = vocab
        self.open = params["loop"] == "open"
        if self.open:
            rate = params["arrivals"]["rate_rps"]
            self.k = max(1, round(rate * seconds))
            self.segment_s = self.k / rate
        else:
            self.k = int(params["population"])
        pop = np.random.default_rng([params["population_seed"], 0])
        self.prompts = lengths(params["prompt"], self.k, pop)
        self.outputs = np.minimum(lengths(params["output"], self.k, pop),
                                  params["max_total"] - self.prompts)
        if self.open:
            g = pop.exponential(size=self.k)
            self.gaps = g / g.sum() * self.segment_s
        else:
            self.gaps = np.zeros(self.k)
        self._segments: dict[int, tuple] = {}
        self._due: list[float] = [0.0]

    def _segment(self, s: int):
        if s not in self._segments:
            rng = np.random.default_rng([self.seed, 1, s])
            self._segments[s] = (rng.permutation(self.k),
                                 rng.permutation(self.gaps))
        return self._segments[s]

    def sizes(self, i: int) -> tuple[int, int, float]:
        """(prompt tokens, output tokens, gap before request i in s).
        A prompt and its output are drawn as a pair of the population."""
        a, g = self._segment(i // self.k)
        j = int(a[i % self.k])
        return (int(self.prompts[j]), int(self.outputs[j]),
                float(g[i % self.k]))

    def due(self, i: int) -> float:
        """Request i's due time (s after the window's start): the sum of
        the gaps before it, the first one included."""
        while len(self._due) <= i + 1:
            n = len(self._due)
            self._due.append(self._due[-1] + self.sizes(n - 1)[2])
        return self._due[i + 1]

    def longest_prompt(self) -> int:
        return int(self.prompts.max())

    def request(self, i: int) -> Spec:
        prompt, out, _ = self.sizes(i)
        rng = np.random.default_rng([self.seed, 2, i])
        tokens = rng.integers(0, self.vocab, size=prompt).tolist()
        return Spec(i, tokens, out, self.due(i) if self.open else 0.0)
