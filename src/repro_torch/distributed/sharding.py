"""Logical-axis sharding rules of the SNN window engine.

Tensors are described by a tuple of logical axis names; the rules map
each name to a grid axis (or None: replicated).  The SNN rules of the
JAX package's ``repro.distributed.sharding``: the neuron axis splits
over the grid's "neuron" axis (rows are independent: each owns its
weights, membrane and LFSR lanes), the packed synapse-word axis stays
whole with its row, and the sample/stream batch axis splits over the
"data" axis of a 2-D (data x neuron) grid.  On a 1-D neuron grid
"data" resolves to replicated, so the same specs drive both placements.

A resolved spec is a tuple with one entry per tensor axis: the grid
axis that splits it, or None.  The LM rules come with the LM scaffold's
placement.
"""

from __future__ import annotations

# Logical axis -> grid axis (or None: replicated).
DEFAULT_RULES: dict = {
    "neurons": "neuron",
    "syn_words": None,
    "data": "data",
}


def logical_spec(names: tuple, mesh, rules: dict = DEFAULT_RULES) -> tuple:
    """The spec of a tensor whose axes carry the logical ``names`` on
    ``mesh`` (a grid with ``axis_names``): per tensor axis the grid axis
    that splits it, or None.  A grid axis the grid lacks resolves to
    None, and no grid axis splits two tensor axes."""
    axes = []
    used: set = set()
    for nm in names:
        ax = rules.get(nm) if nm is not None else None
        if ax not in mesh.axis_names or ax in used:
            ax = None
        used.add(ax)
        axes.append(ax)
    return tuple(axes)
