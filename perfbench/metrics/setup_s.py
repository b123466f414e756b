"""setup_s (s): from the process's start to the window's opening:
imports, the kernels' build (the first run in a checkout), weights drawn
on the card, the cell's shapes warmed once."""


def read(run):
    return run.setup_s
