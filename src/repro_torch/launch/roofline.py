"""Three-term roofline of one traced step, per device, on the H100.

    compute    = FLOPs / peak FLOP/s
    memory     = device-memory bytes / HBM bandwidth
    collective = sum over mesh axes of that axis's bytes / its link rate

The counts are one rank's (``repro_torch.launch.op_cost`` traces rank 0
of the sharded step on its local shards), so they are per device
already.  The port of the JAX package's ``launch/roofline.py``, with the
H100's constants in place of the TPU's and the collective term split by
mesh axis, since the axes ride different links.

Hardware constants (NVIDIA H100 SXM data sheet): 989 TFLOP/s bf16 dense,
3.35 TB/s HBM3, NVLink 900 GB/s a card to the other cards of its host,
450 GB/s each way: the ``model`` axis (inside a host).  ``data`` and
``pod`` cross the host network: one 400 Gb/s NIC a card (the usual
8-NIC H100 host), 50 GB/s each way.
"""

from __future__ import annotations

import dataclasses

PEAK_FLOPS = 989e12     # bf16 dense, per card
HBM_BW = 3.35e12        # bytes / s, per card
NVLINK_BW = 450e9       # bytes / s each way, per card (model axis)
NET_BW = 50e9           # bytes / s each way, per card (400 Gb/s NIC)
LINK_BW = {"model": NVLINK_BW, "data": NET_BW, "pod": NET_BW}
HBM_BYTES = 80e9        # device memory of one card


@dataclasses.dataclass
class Roofline:
    flops: float
    bytes_hbm: float
    bytes_collective: float
    coll_breakdown: dict         # kind -> bytes
    chips: int
    coll_by_axis: dict = dataclasses.field(default_factory=dict)

    @property
    def t_compute(self) -> float:
        return self.flops / PEAK_FLOPS

    @property
    def t_memory(self) -> float:
        return self.bytes_hbm / HBM_BW

    @property
    def t_collective(self) -> float:
        # an axis missing from the table rides the slowest link
        return sum(b / LINK_BW.get(ax, NET_BW)
                   for ax, b in self.coll_by_axis.items())

    @property
    def dominant(self) -> str:
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return max(terms, key=terms.get)

    @property
    def bound_time(self) -> float:
        return max(self.t_compute, self.t_memory, self.t_collective)

    def summary(self) -> dict:
        return {
            "flops_per_chip": self.flops,
            "hbm_bytes_per_chip": self.bytes_hbm,
            "collective_bytes_per_chip": self.bytes_collective,
            "coll_breakdown": self.coll_breakdown,
            "coll_by_axis": self.coll_by_axis,
            "t_compute_s": self.t_compute,
            "t_memory_s": self.t_memory,
            "t_collective_s": self.t_collective,
            "dominant": self.dominant,
        }


def analyze(cost, chips: int) -> Roofline:
    """The roofline of a finished ``op_cost.OpCost`` trace."""
    return Roofline(flops=cost.flops, bytes_hbm=cost.bytes,
                    bytes_collective=sum(cost.collectives.values()),
                    coll_breakdown=dict(cost.collectives), chips=chips,
                    coll_by_axis=dict(cost.coll_by_axis))


def estimate_peak(cfg, shape, chips: int, tp: int, accum: int,
                  arg_bytes: int) -> float:
    """Analytic per-device peak of device memory, the JAX package's
    model (``estimate_tpu_peak``), term for term:

      peak = args (params / optimizer states / cache, this rank's shards)
           + grad buffer (train: params in 2 bytes over the chips)
           + layer carries (train: L x microbatch residual, seq / TP)
           + transient working set (~4 x the largest layer activation)
           + loss chunk logits (train: 2 x B_loc x 512 x V / tp x 4 B)
    """
    dp = chips // tp
    d, n_layers = cfg.d_model, cfg.n_layers + cfg.encoder_layers
    if shape.kind == "train":
        b_micro = max(1, shape.global_batch // accum)
        b_loc = max(1, b_micro // dp)
        t_loc = max(1, shape.seq_len // tp)
        carry = n_layers * b_loc * t_loc * d * 2
        grad_buf = cfg.n_params() * 2 // chips
        act = 4 * b_loc * shape.seq_len * max(d, cfg.d_ff // tp) * 2
        loss = 2 * max(1, shape.global_batch // dp) * 512 \
            * (cfg.vocab_padded // tp) * 4 // max(1, accum)
        return float(arg_bytes + grad_buf + carry + act + loss)
    # inference: args dominate (params + cache); add transients
    b_loc = max(1, shape.global_batch // dp)
    act = 4 * b_loc * min(shape.seq_len, 4096) * d * 2
    return float(arg_bytes + act)


def model_flops(cfg, shape) -> float:
    """MODEL_FLOPS = 6 N D (dense) / 6 N_active D (MoE), D = tokens.

    For decode steps D = global_batch (one token per sequence); training
    counts forward + backward (6 N D), inference 2 N D.
    """
    n = cfg.n_params_active()
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * n * tokens
    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * n * tokens
    return 2.0 * n * shape.global_batch  # decode: one token / seq
