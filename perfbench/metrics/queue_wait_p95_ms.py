"""queue_wait_p95_ms (ms): 95th percentile, over the requests sent in the
window and admitted before the traced slice ended, of their wait in the
engine's queue: from ``submit()`` to leaving the queue for their prefill
(the request's own ``t_submit`` and ``t_admit`` stamps, host clock).

Requests admitted later are left out: stopping the profiler holds the
loop for seconds, and the requests due meanwhile are submitted together
and wait behind each other's prefills, a queue the measurement made."""

from perfbench.harness import percentile


def read(run):
    tr = run.params.get("trace")
    end = run.log.t0 + tr["start_s"] + tr["seconds"] if tr else float("inf")
    v = [f.req.t_admit - f.req.t_submit for f in run.sent_in_window()
         if getattr(f.req, "t_admit", None) is not None
         and f.req.t_admit < end]
    p = percentile(v, 95)
    return None if p is None else 1e3 * p
