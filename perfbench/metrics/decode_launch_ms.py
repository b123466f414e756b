"""decode_launch_ms (ms): mean host time of the traced slice's
``model/decode`` spans (the body of ``Model.decode_step``): the host's
time to enqueue one decode step."""

from perfbench import program_spans


def read(run):
    steps = program_spans.of(run, "model/decode")
    return sum(r.host_ms for r in steps) / len(steps) if steps else None
