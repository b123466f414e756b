"""prefill_ms_per_ktok (ms): the traced prefills' time on the card (each
from its first operation's start to its last one's end) per 1,000 prompt
tokens."""


def read(run):
    t, calls = run.trace, run.calls
    spans = t.durations("pb.prefill")
    if not spans or len(spans) != len(calls["prefill"]):
        return None
    return 1e6 * sum(spans) / sum(calls["prefill"])
