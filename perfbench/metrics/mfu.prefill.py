"""mfu.prefill (%): the model FLOPs of the traced prefills
(``counts.prefill_flops``) over their time on the card, as a share of
the card's bf16 peak."""

from perfbench import counts


def read(run):
    t, calls = run.trace, run.calls
    spans = t.durations("pb.prefill")
    if not spans or len(spans) != len(calls["prefill"]):
        return None
    flops = sum(counts.prefill_flops(run.dims, n) for n in calls["prefill"])
    return 100.0 * flops / sum(spans) / counts.PEAK_FLOPS
