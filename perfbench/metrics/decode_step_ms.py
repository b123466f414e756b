"""decode_step_ms (ms): mean time on the card of the traced decode steps
(``Model.decode_step``, each from its first operation's start to its
last one's end)."""


def read(run):
    spans = run.trace.durations("pb.decode")
    return 1e3 * sum(spans) / len(spans) if spans else None
