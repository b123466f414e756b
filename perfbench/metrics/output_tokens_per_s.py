"""output_tokens_per_s (tokens/s): tokens the engine gave in the window,
over the window."""


def read(run):
    return len(run.token_times()) / run.window_s()
