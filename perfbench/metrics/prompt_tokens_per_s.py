"""prompt_tokens_per_s (tokens/s): prompt tokens of every request whose
prefill returned in the window, over the window."""


def read(run):
    lg = run.log
    n = sum(len(f.spec.tokens) for f in lg.flights
            if f.times and lg.t0 < f.times[0] <= lg.t_close)
    return n / run.window_s()
