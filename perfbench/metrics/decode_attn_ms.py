"""decode_attn_ms (ms): the attention layers' time on the card per decode
step: the device time of the traced slice's ``attn/decode`` spans (qkv,
RoPE, the cache write, attention over the cache, ``wo``; CUDA events)
inside ``model/decode`` spans, over the number of ``model/decode``
spans."""

from perfbench import program_spans


def read(run):
    steps = program_spans.of(run, "model/decode")
    attn = [r for r in program_spans.of(run, "attn/decode")
            if r.parent == "model/decode"]
    if not steps or not attn or any(r.device_ms is None for r in attn):
        return None
    return sum(r.device_ms for r in attn) / len(steps)
