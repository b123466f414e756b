"""flash_roofline (%): the traced flash calls' least time
(``counts.flash_bound`` of each call's shape) over the card's time in
them."""

from perfbench import counts


def read(run):
    t, calls = run.trace, run.calls
    dev = t.device_s("pb.flash@prefill")
    if dev <= 0 or not calls["flash"]:
        return None
    return 100.0 * sum(counts.flash_bound(*c) for c in calls["flash"]) / dev
