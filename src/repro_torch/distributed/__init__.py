"""repro_torch.distributed — logical-axis sharding rules and their
DTensor placements (``sharding``), the LM's spec trees (``specs``), the
single-controller pipeline schedule (``pipeline``), and placement of the
SNN window engine on a (data x neuron) device grid
(:mod:`repro_torch.distributed.snn_mesh`, imported on its own).

``placements(mesh, rules, names)`` is the port's counterpart of the JAX
package's ``named_sharding``: DTensor placements, one per mesh dim.
"""

from repro_torch.distributed.sharding import (DEFAULT_RULES, constrain,
                                              current_mesh, logical_spec,
                                              placements, use_mesh)

__all__ = ["DEFAULT_RULES", "constrain", "current_mesh", "logical_spec",
           "placements", "use_mesh"]
