"""mfu.decode (%): the model FLOPs of the traced decode steps, live
slots only (``counts.decode_flops``), over their time on the card, as a
share of the card's bf16 peak."""

from perfbench import counts


def read(run):
    t, calls = run.trace, run.calls
    spans = t.durations("pb.decode")
    if not spans or len(spans) != len(calls["decode"]):
        return None
    flops = sum(counts.decode_flops(run.dims, keys)
                for keys in calls["decode"])
    return 100.0 * flops / sum(spans) / counts.PEAK_FLOPS
