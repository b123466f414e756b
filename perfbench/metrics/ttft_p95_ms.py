"""ttft_p95_ms (ms): 95th percentile, over every request due (open loop)
or sent (closed loop) in the window, of the time from then to the return
of the engine step that gave its first token."""

from perfbench.harness import percentile


def read(run):
    v = [f.times[0] - f.t_due for f in run.sent_in_window() if f.times]
    p = percentile(v, 95)
    return None if p is None else 1e3 * p
