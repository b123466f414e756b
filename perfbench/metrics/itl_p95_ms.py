"""itl_p95_ms (ms): 95th percentile over every gap between consecutive
output tokens of every request, the later token given in the window
(both tokens of one step count a gap of 0)."""

from perfbench.harness import percentile


def read(run):
    lg = run.log
    v = [b - a for f in lg.flights for a, b in zip(f.times, f.times[1:])
         if lg.t0 < b <= lg.t_close]
    p = percentile(v, 95)
    return None if p is None else 1e3 * p
