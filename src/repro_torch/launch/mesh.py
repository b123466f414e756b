"""Production mesh construction.

Defined as functions (never module-level constants), so importing this
module touches no process group: the dry run starts its fake group
first.

Production topology (H100 target: hosts of 8 cards joined by NVLink, the
hosts by their network):
  single pod:  (data=32, model=8)            = 256 cards
  multi-pod:   (pod=2, data=32, model=8)     = 512 cards
The ``model`` axis stays inside one host's NVLink domain, as the JAX
package keeps it inside the TPU pod's ICI domain; ``data`` and ``pod``
cross the host network (gradient all-reduce, FSDP gathers).  The card
counts are the JAX package's.

A mesh is a ``torch.distributed`` ``DeviceMesh`` over the default
process group, which needs one rank per card: ``torchrun
--nproc-per-node N`` on a host (NCCL puts one rank on a card), or
:func:`fake_world` for a dry run in one process.
"""

from __future__ import annotations

from contextlib import contextmanager

POD = (32, 8)
POD_AXES = ("data", "model")
MULTI_POD = (2, 32, 8)
MULTI_POD_AXES = ("pod", "data", "model")


def production_shape(multi_pod: bool) -> tuple[tuple, tuple]:
    """(shape, axis names) of the production mesh."""
    return (MULTI_POD, MULTI_POD_AXES) if multi_pod else (POD, POD_AXES)


def mesh_name(multi_pod: bool) -> str:
    return "x".join(map(str, production_shape(multi_pod)[0]))


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cpu"):
    """The production mesh over the default process group (its world
    must be 256 ranks, or 512 with ``multi_pod``)."""
    from torch.distributed.device_mesh import init_device_mesh

    shape, axes = production_shape(multi_pod)
    return init_device_mesh(device_type, shape, mesh_dim_names=axes)


def make_local_mesh(model: int = 1, device_type: str = "cuda"):
    """A (data, model) mesh over whatever ranks exist (tests, examples):
    ``model`` ranks a model group (at most the world), the rest data."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    n = dist.get_world_size()
    model = min(model, n)
    return init_device_mesh(device_type, (n // model, model),
                            mesh_dim_names=("data", "model"))


@contextmanager
def fake_world(world_size: int, rank: int = 0):
    """A fake default process group of ``world_size`` ranks in this one
    process (``torch.testing``'s ``FakeStore``, backend ``"fake"``): its
    collectives do nothing and cost nothing, so a sharded step can be
    traced, on ``meta`` tensors, as rank ``rank`` of a cluster that is
    not there.  Destroyed on exit."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=rank,
                            world_size=world_size)
    try:
        yield
    finally:
        dist.destroy_process_group()
