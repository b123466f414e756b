"""repro_torch.distributed — placement of the SNN window engine on a
(data x neuron) device grid (:mod:`repro_torch.distributed.snn_mesh`,
imported on its own) and the logical-axis rules behind it."""

from repro_torch.distributed.sharding import DEFAULT_RULES, logical_spec

__all__ = ["DEFAULT_RULES", "logical_spec"]
