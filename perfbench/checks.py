"""The comparison that decides ``correct``.

Once the window has closed and the program is freed, a sample drawn from
the seed of the requests the engine finished, in any slot (the longest
of them always in it), is run through the plain float32 reference
(``reference/moe_lm.py``), teacher-forced: each prompt with its served
tokens.  Two numbers are compared:

* ``logit_err_mean``: at each served position whose logits the run kept
  (:mod:`perfbench.capture`), the program's logits against the
  reference's, ``|program - reference| / |reference|`` over the row
  (Euclidean norms); the mean over those positions;
* ``gap_mean``: at every served position, how far the served token's
  reference logit lies below the reference's best; the mean.

Means, not widest values: in these MoE models rounding flips routes at
near-ties (an expert swapped, a pair dropped at the capacity's edge
instead of another), and a flipped route moves a position's logits far
more than rounding does, so the widest gap (``gap_max``, printed) and
the widest error read as high on sound runs as on the float8 control.

The reference works the capacity drops out again from the port's
documented rule: the prompt went through one MoE call of its own (the
engine's B=1 prefill).  A decode step is one call over all ``n_slots``
slots, the empty ones too; a request in a slot below the step's
capacity is never dropped there, and the reference drops no decode pair
at all.  In a slot at or above the capacity the program may drop a pair
that the reference keeps: such positions read as a route flip does, and
the sound runs' readings that the limits were set from include them.

Besides: every request due in the window gave its first token
(``failed``), every finished request got the tokens it asked for
(``short``), and enough tokens and logit rows were compared
(``compared``, ``logits_compared``).
"""

from __future__ import annotations

import numpy as np
import torch

from perfbench import weights
from perfbench.reference import moe_lm


def sample(flights, count: int, seed: int) -> list:
    """Up to ``count`` finished flights, drawn from the seed, in any
    slot; the longest always in."""
    ok = [f for f in flights if f.req.done]
    if not ok:
        return []
    ok.sort(key=lambda f: (len(f.spec.tokens) + len(f.req.output),
                           f.spec.index))
    longest, rest = ok[-1], ok[:-1]
    rng = np.random.default_rng([seed % (1 << 64), 4])
    pick = rng.choice(len(rest), size=min(count - 1, len(rest)),
                      replace=False) if count > 1 and rest else []
    return [longest] + [rest[i] for i in sorted(pick)]


def reference_logits(dims, seed: int, flights, device,
                     precision: str = "float32", routes=None):
    """The reference's logits at each flight's served positions."""
    if not flights:
        return []
    seqs, groups, served = [], [], []
    for f in flights:
        prompt, out = f.spec.tokens, f.req.output
        seqs.append(torch.tensor(prompt + out[:-1], device=device))
        groups.append([(0, len(prompt))])
        served.append(list(range(len(prompt) - 1,
                                 len(prompt) + len(out) - 1)))

    def layer(i):
        specs = weights.layer_specs(dims, i)
        prefix = f"layers.{i}."
        return {name[len(prefix):]: weights.draw(name, spec, seed, device)
                for name, spec in specs.items()}

    def outer():
        return {name: weights.draw(name, spec, seed, device)
                for name, spec in weights.outer_specs(dims).items()}

    with torch.no_grad():
        return moe_lm.logits(dims, seqs, groups, layer, outer, served,
                             precision=precision, routes=routes)


def compare(refs, tokens, rows) -> dict:
    """Served outputs against the reference.

    refs: per flight, the reference's logits [n_served, V]; tokens: per
    flight, the served tokens; rows: per flight, {position: the served
    logits row} at the positions kept.  Returns the compared numbers
    and, printed beside them, the widest of each."""
    gaps, errs = [], []
    for ref, tok, kept in zip(refs, tokens, rows):
        tok = torch.as_tensor(tok, device=ref.device)
        gaps.append(moe_lm.gaps(ref, tok).cpu().numpy())
        for pos, row in kept.items():
            r = ref[pos]
            p = row[:r.shape[0]].to(device=r.device, dtype=torch.float32)
            errs.append(float(torch.linalg.vector_norm(p - r)
                              / torch.linalg.vector_norm(r)))
    g = np.concatenate(gaps) if gaps else np.zeros(0)
    e = np.asarray(errs)
    nan = float("nan")
    return {"logit_err_mean": float(e.mean()) if e.size else nan,
            "gap_mean": float(g.mean()) if g.size else nan,
            "compared": int(g.size), "logits_compared": int(e.size),
            "widest": {"logit_err": float(e.max()) if e.size else nan,
                       "gap": float(g.max()) if g.size else nan}}


def judge(values: dict, limits: dict) -> tuple[bool, dict]:
    """(every check within its limit, {name: {value, limit}}).  A limit
    is {"max": x} or {"min": x}; a number that is not a number fails."""
    ok, shown = True, {}
    for name, lim in limits.items():
        v = values[name]
        if "max" in lim:
            good, bound = v <= lim["max"], lim["max"]
        else:
            good, bound = v >= lim["min"], lim["min"]
        ok &= bool(good)
        shown[name] = {"value": v, "limit": bound}
    return ok, shown
