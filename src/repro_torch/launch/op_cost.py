"""FLOPs, device-memory bytes and collective bytes of one traced step.

The port's counterpart of the JAX package's ``launch/hlo_cost.py``.  The
port has no HLO to parse: PyTorch runs eagerly, so the step is run once
under :class:`OpCost`, a ``TorchDispatchMode``, on ``meta`` tensors (no
allocation, no arithmetic) in one rank of a fake process group
(``launch.mesh.fake_world``), and every op is counted as it runs.  The
port's loops (layers, loss chunks, attention chunks, microbatches) are
Python, so each traced op counts once per time it runs: that takes the
place of ``hlo_cost``'s while-loop trip counts.

* FLOPs: ``torch.utils.flop_counter``'s formulas, on the op's local
  shapes.  A DTensor op is let through (``NotImplemented``, as
  ``CommDebugMode`` does) and counted as the local ops and collectives
  DTensor turns it into, so every count is this rank's.
* Bytes: each op's tensor inputs plus outputs (views, aliases and
  metadata ops move nothing), the eager port's device-memory traffic.
* Collectives: the functional collectives DTensor dispatches
  (``all_gather_into_tensor``, ``reduce_scatter_tensor``,
  ``all_reduce``, ``all_to_all_single``), their output bytes by kind
  (as ``hlo_cost`` counts them) and by the mesh axis whose group they
  run on, each with the innermost ``repro_torch`` frame that issued it
  (``records``, for ``launch.debug_colls``).
* Memory: the live bytes of every storage this rank holds, tracked from
  creation to release (``track`` adds existing tensors, such as the
  step's arguments); ``peak`` is the most at once.

The global-shaped stand-ins that DTensor's sharding propagation runs
ops on (to infer output shapes) are left out of every count.
"""

from __future__ import annotations

import contextlib
import sys
import traceback
import weakref
from collections import Counter

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from repro_torch.models.layers import scan as _scan

_COLLECTIVES = {
    "all_gather_into_tensor": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "all_reduce": "all-reduce",
    "all_to_all_single": "all-to-all",
}


def _tensors(x):
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, (list, tuple)):
        for y in x:
            yield from _tensors(y)
    elif isinstance(x, dict):
        for y in x.values():
            yield from _tensors(y)


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _in_sharding_propagation() -> bool:
    """Whether DTensor's sharding propagation is on the stack: it runs
    the op on global-shaped meta stand-ins to infer shapes, which is no
    work of the step."""
    f = sys._getframe(2)
    for _ in range(40):
        if f is None:
            return False
        if f.f_code.co_filename.endswith("_sharding_prop.py"):
            return True
        f = f.f_back
    return False


def _source() -> str:
    """The innermost frame of the port's own code (not its sharding
    plumbing) on the stack: where a collective was issued."""
    frames = [f for f in traceback.extract_stack()
              if "/repro_torch/" in f.filename
              and "/launch/op_cost.py" not in f.filename]
    inner = [f for f in frames
             if "/distributed/sharding.py" not in f.filename] or frames
    if not inner:
        return "?"
    f = inner[-1]
    path = f.filename.split("/repro_torch/")[-1]
    return f"{path}:{f.lineno} {f.name}"


class OpCost(TorchDispatchMode):
    """Count one step (see the module docstring).  ``mesh``: the
    ``DeviceMesh`` whose groups name the collectives' axes;
    ``trip_count``: count ``models.layers.scan`` loops by their trip
    count (False: trace every step)."""

    def __init__(self, mesh=None, trip_count: bool = True):
        super().__init__()
        self.trip_count = trip_count
        self.scale = 1
        self._pending: list[tuple] = []
        self._reserved: dict[int, weakref.finalize] = {}
        self.flops = 0
        self.bytes = 0
        self.collectives: Counter = Counter()
        self.coll_by_axis: Counter = Counter()
        self.records: list[dict] = []
        self.live = 0
        self.peak = 0
        self._held: dict[int, weakref.finalize] = {}
        self._axes = {}
        if mesh is not None:
            for name in mesh.mesh_dim_names:
                self._axes[mesh.get_group(name).group_name] = name

    # --- memory ------------------------------------------------------------

    def _free(self, key: int, n: int) -> None:
        self._held.pop(key, None)
        self.live -= n

    def track(self, *trees) -> int:
        """Count the storages of the tensors in ``trees`` (DTensors by
        their local shards) as live.  Returns the bytes added."""
        from torch.distributed.tensor import DTensor

        added = 0
        for t in _tensors(list(trees)):
            if isinstance(t, DTensor):
                t = t.to_local()
            added += self._hold(t)
        return added

    def _hold(self, t: torch.Tensor) -> int:
        s = t.untyped_storage()
        key = id(s)
        if key in self._held:
            return 0
        n = s.nbytes()
        self._held[key] = weakref.finalize(s, self._free, key, n)
        self.live += n
        self.peak = max(self.peak, self.live)
        return n

    def reserve(self, n: int):
        """Count ``n`` more bytes live (memory a loop counted by its
        trip count does not trace) until the returned function is
        called."""
        self.live += n
        self.peak = max(self.peak, self.live)

        def release():
            nonlocal n
            self.live -= n
            n = 0
        return release

    def reserve_while(self, n: int, owner: torch.Tensor) -> None:
        """Count ``n`` more bytes live, from now on, for as long as the
        storage of ``owner`` lives (or until :meth:`release`).  Settled
        at the next op: by then autograd has kept ``owner`` as a saved
        tensor or let it go (a checkpointed forward)."""
        self._pending.append((weakref.ref(owner.untyped_storage()), n,
                              self.live))

    def release(self, owner: torch.Tensor) -> None:
        """End the reservation of ``owner`` early."""
        self._settle()
        fin = self._reserved.get(owner.untyped_storage()._cdata)
        if fin is not None:
            fin()

    def _settle(self) -> None:
        pending, self._pending = self._pending, []
        for ref, n, live_then in pending:
            s = ref()
            if s is None:
                continue
            self.live += n
            self.peak = max(self.peak, live_then + n, self.live)
            self._reserved[s._cdata] = weakref.finalize(
                s, self._unreserve, s._cdata, n)

    def _unreserve(self, key, n: int) -> None:
        self._reserved.pop(key, None)
        self.live -= n

    @contextlib.contextmanager
    def scaled(self, times: int):
        """Count each op inside ``times`` times (a loop's trip count);
        at 0 an op is not seen at all, nor is its memory."""
        outer, self.scale = self.scale, self.scale * times
        try:
            yield
        finally:
            self.scale = outer

    def __enter__(self):
        if self.trip_count:
            _scan.counters.append(self)
        return super().__enter__()

    def __exit__(self, *exc):
        if self.trip_count:
            _scan.counters.remove(self)
        return super().__exit__(*exc)

    # --- dispatch ----------------------------------------------------------

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor

        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        kwargs = kwargs or {}
        if self._pending:
            self._settle()
        out = func(*args, **kwargs)
        if self.scale == 0 or _in_sharding_propagation():
            return out
        times = self.scale
        packet = func._overloadpacket
        if func.namespace in ("_c10d_functional", "c10d_functional"):
            kind = _COLLECTIVES.get(packet.__name__)
            if kind is not None:
                n = sum(_nbytes(t) for t in _tensors(out))
                groups = [a for a in args if isinstance(a, str)]
                axis = self._axes.get(groups[-1] if groups else None,
                                      groups[-1] if groups else "?")
                self.collectives[kind] += n * times
                self.coll_by_axis[axis] += n * times
                self.records.extend([{"kind": kind, "bytes": n, "axis": axis,
                                      "source": _source()}] * times)
        elif func.namespace != "prim" and not func.is_view:
            if packet in flop_registry:
                self.flops += times * flop_registry[packet](
                    *args, **kwargs, out_val=out)
            self.bytes += times * (
                sum(_nbytes(t) for t in _tensors((args, kwargs)))
                + sum(_nbytes(t) for t in _tensors(out)))
        for t in _tensors(out):
            self._hold(t)
        return out
