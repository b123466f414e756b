"""experts_roofline.decode (%): in the traced decode steps, the least
time of the expert products (``counts.experts_bound``: every expert's
weights read once, against the live tokens' top-k products) over their
time on the card."""

from perfbench import counts


def read(run):
    t, calls = run.trace, run.calls
    dev = t.device_s("pb.moe.experts@decode")
    if dev <= 0 or not calls["decode"]:
        return None
    bound = sum(run.dims.n_layers * counts.experts_bound(run.dims, len(keys))
                for keys in calls["decode"])
    return 100.0 * bound / dev
