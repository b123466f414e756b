"""The port's own spans of one run, for the metric readers.

``repro_torch.runtime.tracing`` keeps the spans the program opened while
a profiler session recorded, in the process's memory; in a traced run
that is the traced slice.  :func:`of` returns those of one name that
began and ended inside the run (earlier runs in the process left
theirs), or nothing where the program has no such module or span.
"""


def of(run, name: str) -> list:
    try:
        from repro_torch.runtime import tracing
    except ImportError:
        return []
    lo, hi = run.log.t0 * 1e9, run.log.t_end * 1e9
    return [r for r in tracing.records(name)
            if lo <= r.t0_ns and r.t1_ns <= hi]
