"""moe_dispatch_share (%): in the traced prefills, the card's time in
the MoE layer outside the expert products (routing, the slots' cumsum,
the scatter into the expert buffer, the gather and the combine) over its
time in the whole layer."""


def read(run):
    t = run.trace
    whole = t.device_s("pb.moe.forward@prefill")
    if whole <= 0:
        return None
    return 100.0 * (whole - t.device_s("pb.moe.experts@prefill")) / whole
