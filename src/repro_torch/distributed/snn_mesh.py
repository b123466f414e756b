"""Placement of the SNN window engine on a (data x neuron) device grid.

These are the low-level wrappers behind the engine's plan placement:
build an ``SNNEnginePlan(mesh=...)`` (or declaratively
``mesh_shape=(data, neurons)``) and :class:`repro_torch.engine.SNNEngine`
dispatches its window verbs here.  The functions stay callable directly
(the ``--check``/``--bench`` CLI uses them), with the JAX package's
names and signatures.

The window kernels take neuron rows independently: every row owns its
weights, membrane and LFSR lanes, and the small packed spike window is
shared read-only.  The batched ops add a second independent axis,
streams or samples: each stream owns its register file, each sample its
window or intensity row, and the in-kernel encode draws spikes from
per-sample counter seeds, which any device regenerates bit for bit.  A
grid therefore factorizes the devices over both axes::

                 neuron axis (populations) ->
               +----------------+----------------+
      data     |  dev(0,0)      |  dev(0,1)      |   samples 0..B/2
      axis     |  rows 0..n/2   |  rows n/2..n   |
    (samples)  +----------------+----------------+
        |      |  dev(1,0)      |  dev(1,1)      |   samples B/2..B
        v      |  rows 0..n/2   |  rows n/2..n   |
               +----------------+----------------+

Each wrapper pads its rows (LFSR lanes with 1, never 0), splits neuron
rows over the grid's "neuron" axis and batch or stream rows over
"data", runs the same :mod:`repro_torch.kernels.ops` call on each
shard's device (every shard is issued before any result is read),
gathers the results on the grid's first device and slices the padding
off.  There are no collectives and no cross-shard PRNG state, so any
factorization is bit-exact with the unsharded op; a call makes one
launch per shard, d x n in all.  A one-sample wrapper (no batch axis)
runs on every data row of a 2-D grid, each row alike, and keeps row 0.

The grid is a single controller's, as the JAX package's ``shard_map``
is: one process issues every shard, so the engine's API stays one call
per verb.  A grid's devices are named explicitly, and a list may name
one device several times: the counterpart of XLA's
``--xla_force_host_platform_device_count``, which is how the CPU tests
and a one-card machine run every shape.  The default takes the visible
cards and raises when there are too few.  Specs come from the
logical-axis rules of :mod:`repro_torch.distributed.sharding`.

    python -m repro_torch.distributed.snn_mesh --check --device cpu \\
        --devices 8                                     # 1-D, 8 shards
    python -m repro_torch.distributed.snn_mesh --check --device cpu \\
        --mesh-shape 2,4 --mesh-shape 4,2 --mesh-shape 8,1   # 2-D grids
    python -m repro_torch.distributed.snn_mesh --check --on cuda:0 \\
        --devices 8                      # every shard on one card

``--check`` asserts sharded == unsharded outputs (``torch.equal``) for
every wrapper (pre-packed and in-kernel encode, infer and train) on
each requested grid; ``--bench`` times sharded against unsharded and
prints one ``BENCH`` (or, with ``--mesh-shape``, ``BENCH2D``) line.
"""

from __future__ import annotations

import dataclasses
import functools
import sys

import torch

from repro_torch.distributed.sharding import logical_spec
from repro_torch.kernels import ops

_AXIS = "neuron"
_DATA_AXIS = "data"


def canonical_device(device) -> torch.device:
    """``device`` with a CUDA index filled in (the current card's)."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        idx = torch.cuda.current_device() if torch.cuda.is_available() else 0
        dev = torch.device("cuda", idx)
    return dev


@dataclasses.dataclass(frozen=True)
class SNNMesh:
    """A grid of devices: ``devices[i][j]`` runs data row i and neuron
    column j.  A 1-D neuron grid has one data row and the single axis
    "neuron"; a 2-D grid has the axes ("data", "neuron").  Frozen and
    hashable, so a plan that holds one stays a cache key."""
    devices: tuple
    axis_names: tuple

    @property
    def shape(self) -> dict:
        """Extents by axis name, as ``jax.sharding.Mesh.shape``."""
        ext = {_DATA_AXIS: len(self.devices), _AXIS: len(self.devices[0])}
        return {a: ext[a] for a in self.axis_names}

    @property
    def first(self) -> torch.device:
        """The device results are gathered on."""
        return self.devices[0][0]

    @property
    def size(self) -> int:
        return len(self.devices) * len(self.devices[0])


def visible_devices() -> list[torch.device]:
    """The CUDA cards this process sees."""
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def _grid_devices(need: int, devices, what: str) -> list[torch.device]:
    devs = (visible_devices() if devices is None
            else [canonical_device(d) for d in devices])
    if need > len(devs):
        raise ValueError(f"asked for {what} ({need} devices), have "
                         f"{len(devs)}")
    return devs[:need]


def snn_mesh(n_devices: int | None = None, devices=None) -> SNNMesh:
    """1-D neuron grid over (the first ``n_devices`` of) ``devices``,
    default the visible cards."""
    if devices is None and n_devices is None:
        n_devices = len(visible_devices())
    elif n_devices is None:
        n_devices = len(devices)
    if n_devices < 1:
        raise ValueError(f"a grid needs at least one device, got "
                         f"{n_devices}")
    devs = _grid_devices(n_devices, devices, f"{n_devices} devices")
    return SNNMesh((tuple(devs),), (_AXIS,))


def snn_mesh2d(data: int, neurons: int, devices=None) -> SNNMesh:
    """2-D (data x neuron) grid over the first data*neurons of
    ``devices``, default the visible cards.

    Sample/stream batch axes split over ``data``, neuron rows over
    ``neurons``; ``snn_mesh2d(1, d)`` and ``snn_mesh(d)`` give
    bit-identical results through every wrapper below.
    """
    if data < 1 or neurons < 1:
        raise ValueError(f"mesh extents must be >= 1, got "
                         f"({data}, {neurons})")
    devs = _grid_devices(data * neurons, devices,
                         f"a {data}x{neurons} mesh")
    return SNNMesh(tuple(tuple(devs[i * neurons:(i + 1) * neurons])
                         for i in range(data)), (_DATA_AXIS, _AXIS))


def _dims(mesh: SNNMesh) -> tuple[int, int]:
    """(data, neuron) extents; data is 1 on a 1-D neuron grid."""
    return len(mesh.devices), len(mesh.devices[0])


def _specs(mesh: SNNMesh, *names_tuples):
    return tuple(logical_spec(names, mesh) for names in names_tuples)


def _pad_rows(x: torch.Tensor, mult: int, fill=0, axis: int = 0
              ) -> torch.Tensor:
    pad = (-x.shape[axis]) % mult
    if pad == 0:
        return x
    shape = list(x.shape)
    shape[axis] = pad
    return torch.cat([x, x.new_full(shape, fill)], dim=axis)


def _block(x: torch.Tensor, spec: tuple, coord: dict) -> torch.Tensor:
    """Shard ``coord``'s block of ``x``: every axis that ``spec`` splits
    over a grid axis of ``parts`` shards keeps its ``coord``-th part."""
    for dim, ax in enumerate(spec):
        if ax is not None:
            parts, idx = coord[ax]
            size = x.shape[dim] // parts
            x = x.narrow(dim, idx * size, size)
    return x


def _gather(blocks: list, spec: tuple, dev: torch.device) -> torch.Tensor:
    """One output from its shards' blocks (``blocks[i][j]``) on
    ``dev``: neuron columns and data rows concatenated along the axes
    ``spec`` gives them; an axis ``spec`` does not split keeps row or
    column 0 (every row or column computed the same)."""
    def cat(parts, ax):
        parts = [p.to(dev) for p in parts]
        return torch.cat(parts, dim=spec.index(ax)) if ax in spec else parts[0]

    return cat([cat(row, _AXIS) for row in blocks], _DATA_AXIS)


def _shard_map(mesh: SNNMesh, fn, in_specs: tuple, out_specs: tuple,
               *args, strided: tuple = ()) -> tuple:
    """``fn`` on every shard's blocks of ``args`` (split by
    ``in_specs``), each on its shard's device; the outputs gathered by
    ``out_specs`` on the grid's first device.  Blocks are made
    contiguous, except the arguments whose index is in ``strided`` (the
    stream op takes any strides on its sample and stream axes)."""
    dd, nd = _dims(mesh)
    outs = []
    for i in range(dd):
        row = []
        for j in range(nd):
            coord = {_DATA_AXIS: (dd, i), _AXIS: (nd, j)}
            dev = mesh.devices[i][j]
            blocks = []
            for k, (a, spec) in enumerate(zip(args, in_specs)):
                b = _block(a, spec, coord).to(dev)
                blocks.append(b if k in strided else b.contiguous())
            out = fn(*blocks)
            row.append(out if isinstance(out, tuple) else (out,))
        outs.append(row)
    return tuple(_gather([[o[k] for o in row] for row in outs], spec,
                         mesh.first)
                 for k, spec in enumerate(out_specs))


def sharded_infer_window_batch(weights, spike_trains, *, threshold: int,
                               leak: int, t_chunk: int | None = None,
                               backend: str = "kernel",
                               mesh: SNNMesh | None = None) -> torch.Tensor:
    """:func:`ops.infer_window_batch` over a grid.

    weights [n, w] split on n; spike_trains [B, T, w] split on B over
    "data" (replicated on a 1-D grid); counts int32[B, n] gathered from
    both.  Bit-exact with the unsharded op on any grid.
    """
    mesh = snn_mesh() if mesh is None else mesh
    dd, nd = _dims(mesh)
    n = weights.shape[0]
    b = spike_trains.shape[0]
    wp = _pad_rows(weights, nd)
    tp = _pad_rows(spike_trains, dd)
    row, trains, out = _specs(mesh, ("neurons", "syn_words"),
                              ("data", None, "syn_words"),
                              ("data", "neurons"))
    fn = functools.partial(ops.infer_window_batch, threshold=threshold,
                           leak=leak, t_chunk=t_chunk, backend=backend)
    counts, = _shard_map(mesh, fn, (row, trains), (out,), wp, tp)
    return counts[:b, :n].contiguous()


def sharded_fused_snn_window(weights, spike_train, v, lfsr_state, teach, *,
                             threshold: int, leak: int, w_exp: int,
                             gain: int, n_syn: int, ltp_prob=1023,
                             train: bool = True,
                             t_chunk: int | None = None,
                             backend: str = "kernel",
                             mesh: SNNMesh | None = None):
    """:func:`ops.fused_snn_window` over a grid.

    weights/lfsr [n, w], v/teach int32[n] split on n; the spike window
    is replicated (on every data row of a 2-D grid too: one sample has
    no batch axis to split); the fired raster bool[T, n] is gathered
    from the neuron shards.  Each shard's LFSR lanes travel with its
    rows, so training stays bit-exact with the unsharded op.  Returns
    (weights', v', fired bool[T, n], lfsr').
    """
    mesh = snn_mesh() if mesh is None else mesh
    _, nd = _dims(mesh)
    n = weights.shape[0]
    wp = _pad_rows(weights, nd)
    vp = _pad_rows(v, nd)
    tp = _pad_rows(teach, nd)
    sp = _pad_rows(lfsr_state, nd, fill=1)
    row, vec, rep2, ras = _specs(
        mesh, ("neurons", "syn_words"), ("neurons",),
        (None, "syn_words"), (None, "neurons"))
    fn = functools.partial(ops.fused_snn_window, threshold=threshold,
                           leak=leak, w_exp=w_exp, gain=gain, n_syn=n_syn,
                           ltp_prob=ltp_prob, train=train, t_chunk=t_chunk,
                           backend=backend)
    w2, v2, fired, s2 = _shard_map(mesh, fn, (row, rep2, vec, row, vec),
                                   (row, vec, ras, row), wp, spike_train,
                                   vp, sp, tp)
    return (w2[:n].contiguous(), v2[:n].contiguous(),
            fired[:, :n].contiguous(), s2[:n].contiguous())


def sharded_train_window_batch(weights, spike_trains, v, lfsr_state,
                               teach, *, threshold: int, leak: int,
                               w_exp: int, gain: int, n_syn: int,
                               ltp_prob=1023, t_chunk: int | None = None,
                               backend: str = "kernel",
                               mesh: SNNMesh | None = None):
    """:func:`ops.train_window_batch` over a grid.

    weights/lfsr [B, n, w], v/teach int32[B, n] split on n and on the
    stream axis over "data" (every stream's rows travel with their LFSR
    lanes); the spike windows [B, T, w] and the per-stream ``ltp_prob``
    (int or int32[B]) split on "data" only.  On a 2-D grid device
    (i, j) trains its B/d streams x its n/nd rows.  Returns (weights',
    v', fired bool[B, T, n], lfsr').
    """
    mesh = snn_mesh() if mesh is None else mesh
    dd, nd = _dims(mesh)
    b, n, _ = weights.shape
    wp = _pad_rows(_pad_rows(weights, nd, axis=1), dd)
    vp = _pad_rows(_pad_rows(v, nd, axis=1), dd)
    tp = _pad_rows(_pad_rows(teach, nd, axis=1), dd)
    sp = _pad_rows(_pad_rows(lfsr_state, nd, fill=1, axis=1), dd, fill=1)
    kp = _pad_rows(spike_trains, dd)
    lp = _pad_rows(ops.seed_vector(ltp_prob, b, weights.device), dd)
    row3, vecb, trains, per, ras3 = _specs(
        mesh, ("data", "neurons", "syn_words"), ("data", "neurons"),
        ("data", None, "syn_words"), ("data",), ("data", None, "neurons"))

    def call(w, s, vv, st, tc, lp_):
        return ops.train_window_batch(
            w, s, vv, st, tc, threshold=threshold, leak=leak,
            w_exp=w_exp, gain=gain, n_syn=n_syn, ltp_prob=lp_,
            t_chunk=t_chunk, backend=backend)

    w2, v2, fired, s2 = _shard_map(
        mesh, call, (row3, trains, vecb, row3, vecb, per),
        (row3, vecb, ras3, row3), wp, kp, vp, sp, tp, lp)
    return (w2[:b, :n].contiguous(), v2[:b, :n].contiguous(),
            fired[:b, :, :n].contiguous(), s2[:b, :n].contiguous())


def sharded_infer_window_batch_encode(weights, intensities, seeds, *,
                                      n_steps: int, threshold: int,
                                      leak: int, t_total=None,
                                      t_chunk: int | None = None,
                                      backend: str = "kernel",
                                      mesh: SNNMesh | None = None
                                      ) -> torch.Tensor:
    """:func:`ops.infer_window_batch_encode` over a grid.

    weights split on n; intensities uint8[B, n_in], per-sample seeds and
    the optional ``t_total`` split on "data" (padded samples take seed 0
    and ``t_total`` = ``n_steps``).  The counter draw is stateless, so
    every neuron shard regenerates the same spikes from its samples'
    (seed, cycle) keys.  Bit-exact with the unsharded op on any grid.
    """
    mesh = snn_mesh() if mesh is None else mesh
    dd, nd = _dims(mesh)
    n = weights.shape[0]
    b = intensities.shape[0]
    dev = weights.device
    wp = _pad_rows(weights, nd)
    xp = _pad_rows(intensities, dd)
    sd = _pad_rows(ops.seed_vector(seeds, b, dev), dd)
    tt = ops.seed_vector(n_steps if t_total is None else t_total, b, dev)
    tt = _pad_rows(tt, dd, fill=n_steps)
    row, inten, per, out = _specs(mesh, ("neurons", "syn_words"),
                                  ("data", None), ("data",),
                                  ("data", "neurons"))

    def call(w, x, s, t):
        return ops.infer_window_batch_encode(
            w, x, s, n_steps=n_steps, threshold=threshold, leak=leak,
            t_total=t, t_chunk=t_chunk, backend=backend)

    counts, = _shard_map(mesh, call, (row, inten, per, per), (out,), wp, xp,
                         sd, tt)
    return counts[:b, :n].contiguous()


def sharded_fused_snn_window_encode(weights, intensities, seed, v,
                                    lfsr_state, teach, *, n_steps: int,
                                    threshold: int, leak: int, w_exp: int,
                                    gain: int, n_syn: int, ltp_prob=1023,
                                    train: bool = True,
                                    t_chunk: int | None = None,
                                    backend: str = "kernel",
                                    mesh: SNNMesh | None = None):
    """:func:`ops.fused_snn_window_encode` over a grid.

    State split on n as in :func:`sharded_fused_snn_window`; the uint8
    intensities are replicated (n_in bytes instead of a T*w*4-byte
    window) and the counter seed closes over the call.  Bit-exact with
    the unsharded op, each shard's LFSR sequence included.
    """
    mesh = snn_mesh() if mesh is None else mesh
    _, nd = _dims(mesh)
    n = weights.shape[0]
    wp = _pad_rows(weights, nd)
    vp = _pad_rows(v, nd)
    tp = _pad_rows(teach, nd)
    sp = _pad_rows(lfsr_state, nd, fill=1)
    row, vec, rep1, ras = _specs(
        mesh, ("neurons", "syn_words"), ("neurons",), (None,),
        (None, "neurons"))

    def call(w, x, vv, st, tc):
        return ops.fused_snn_window_encode(
            w, x, seed, vv, st, tc, n_steps=n_steps, threshold=threshold,
            leak=leak, w_exp=w_exp, gain=gain, n_syn=n_syn,
            ltp_prob=ltp_prob, train=train, t_chunk=t_chunk,
            backend=backend)

    w2, v2, fired, s2 = _shard_map(mesh, call, (row, rep1, vec, row, vec),
                                   (row, vec, ras, row), wp, intensities,
                                   vp, sp, tp)
    return (w2[:n].contiguous(), v2[:n].contiguous(),
            fired[:, :n].contiguous(), s2[:n].contiguous())


def sharded_train_window_batch_encode(weights, intensities, seeds, v,
                                      lfsr_state, teach, *, n_steps: int,
                                      threshold: int, leak: int,
                                      w_exp: int, gain: int, n_syn: int,
                                      ltp_prob=1023,
                                      t_chunk: int | None = None,
                                      backend: str = "kernel",
                                      mesh: SNNMesh | None = None):
    """:func:`ops.train_window_batch_encode` over a grid.

    Per-stream state split on n and on "data"; intensities
    uint8[B, n_in], per-sample seeds and ``ltp_prob`` split on "data"
    only, so each stream's n_in intensity bytes land exactly on the
    devices that train it.  Bit-exact with the unsharded op on any grid.
    """
    mesh = snn_mesh() if mesh is None else mesh
    dd, nd = _dims(mesh)
    b, n, _ = weights.shape
    dev = weights.device
    wp = _pad_rows(_pad_rows(weights, nd, axis=1), dd)
    vp = _pad_rows(_pad_rows(v, nd, axis=1), dd)
    tp = _pad_rows(_pad_rows(teach, nd, axis=1), dd)
    sp = _pad_rows(_pad_rows(lfsr_state, nd, fill=1, axis=1), dd, fill=1)
    xp = _pad_rows(intensities, dd)
    lp = _pad_rows(ops.seed_vector(ltp_prob, b, dev), dd)
    sd = _pad_rows(ops.seed_vector(seeds, b, dev), dd)
    row3, vecb, inten, per, ras3 = _specs(
        mesh, ("data", "neurons", "syn_words"), ("data", "neurons"),
        ("data", None), ("data",), ("data", None, "neurons"))

    def call(w, x, s, vv, st, tc, lp_):
        return ops.train_window_batch_encode(
            w, x, s, vv, st, tc, n_steps=n_steps, threshold=threshold,
            leak=leak, w_exp=w_exp, gain=gain, n_syn=n_syn, ltp_prob=lp_,
            t_chunk=t_chunk, backend=backend)

    w2, v2, fired, s2 = _shard_map(
        mesh, call, (row3, inten, per, vecb, row3, vecb, per),
        (row3, vecb, ras3, row3), wp, xp, sd, vp, sp, tp, lp)
    return (w2[:b, :n].contiguous(), v2[:b, :n].contiguous(),
            fired[:b, :, :n].contiguous(), s2[:b, :n].contiguous())


def sharded_train_stream_batch_encode(weights, intensities, seeds,
                                      lfsr_state, teach, *, n_steps: int,
                                      threshold: int, leak: int,
                                      w_exp: int, gain: int, n_syn: int,
                                      ltp_prob=1023,
                                      backend: str = "kernel",
                                      mesh: SNNMesh | None = None):
    """:func:`ops.train_stream_batch_encode` over a grid: the engine's
    stream drivers under a placement (the JAX package has no stream
    kernel; its drivers scan the sharded one-sample op).

    weights/lfsr [B, n, w] split on n and on the stream axis over
    "data"; intensities uint8[N, B, n_in], seeds (int | i32[N] |
    i32[N, B]) and ``ltp_prob`` split on the stream axis; teach
    int32[N, B, n] on both.  Each shard trains its streams' rows over
    all N samples in one launch.  Returns (weights', v' of the last
    sample, counts int32[N, B, n], lfsr').
    """
    mesh = snn_mesh() if mesh is None else mesh
    dd, nd = _dims(mesh)
    b, n, _ = weights.shape
    n_samples = intensities.shape[0]
    dev = weights.device
    wp = _pad_rows(_pad_rows(weights, nd, axis=1), dd)
    sp = _pad_rows(_pad_rows(lfsr_state, nd, fill=1, axis=1), dd, fill=1)
    xp = _pad_rows(intensities, dd, axis=1)
    sd = _pad_rows(ops._seed_matrix(seeds, n_samples, b, dev), dd, axis=1)
    tp = _pad_rows(_pad_rows(teach, nd, axis=2), dd, axis=1)
    lp = _pad_rows(ops.seed_vector(ltp_prob, b, dev), dd)
    row3, vecb, inten, per2, teach3, per, counts3 = _specs(
        mesh, ("data", "neurons", "syn_words"), ("data", "neurons"),
        (None, "data", None), (None, "data"), (None, "data", "neurons"),
        ("data",), (None, "data", "neurons"))

    def call(w, x, s, st, tc, lp_):
        return ops.train_stream_batch_encode(
            w, x, s, st, tc, n_steps=n_steps, threshold=threshold,
            leak=leak, w_exp=w_exp, gain=gain, n_syn=n_syn, ltp_prob=lp_,
            backend=backend)

    w2, v2, counts, s2 = _shard_map(
        mesh, call, (row3, inten, per2, row3, teach3, per),
        (row3, vecb, counts3, row3), wp, xp, sd, sp, tp, lp,
        strided=(1, 2, 4))
    return (w2[:b, :n].contiguous(), v2[:b, :n].contiguous(),
            counts[:, :b, :n].contiguous(), s2[:b, :n].contiguous())


# --- the CLI -----------------------------------------------------------------

def _parse_mesh_shapes(shapes) -> list[tuple[int, int]]:
    out = []
    for s in shapes or []:
        parts = s.split(",")
        if len(parts) != 2:
            raise SystemExit(f"--mesh-shape wants D,N — got {s!r}")
        out.append((int(parts[0]), int(parts[1])))
    return out


def _devices_for(args, need: int):
    """The grid's device list: ``--on`` repeated, the CPU repeated for
    ``--device cpu``, else None (the visible cards)."""
    if args.on is not None:
        return [args.on] * need
    if torch.device(args.device).type == "cpu":
        return ["cpu"] * need
    return None


def _n_devices(args) -> int:
    if args.devices is not None:
        return args.devices
    if args.on is not None or torch.device(args.device).type == "cpu":
        return 8
    return len(visible_devices())


def _meshes(args) -> list[SNNMesh]:
    shapes = _parse_mesh_shapes(args.mesh_shape)
    if shapes:
        return [snn_mesh2d(d, n, _devices_for(args, d * n))
                for d, n in shapes]
    n_dev = _n_devices(args)
    return [snn_mesh(n_dev, _devices_for(args, n_dev))]


def _mesh_label(mesh: SNNMesh) -> str:
    dd, nd = _dims(mesh)
    if _DATA_AXIS in mesh.axis_names:
        return f"{dd}x{nd} mesh"
    return f"{nd} devices"


def _equal(what: str, got, want) -> None:
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    for g, r in zip(got, want, strict=True):
        if not torch.equal(g, r):
            raise AssertionError(f"{what}: sharded != unsharded")


def _launched(fn, *args, **kw) -> tuple:
    """``fn(*args, **kw)`` and the kernel launches it made, by kernel
    (only the kernels it launched)."""
    before = ops.launch_counts()
    out = fn(*args, **kw)
    after = ops.launch_counts()
    return out, {k: after[k] - before[k] for k in after
                 if after[k] != before[k]}


def _compare(what: str, sharded, unsharded, *args, mesh: SNNMesh,
             on_card: bool, total: dict, **kw) -> None:
    """``sharded(*args, mesh=mesh, **kw)`` against ``unsharded(*args,
    **kw)``: equal outputs, and the sharded call's own launches are the
    unsharded call's times the grid's size (on the card at least one a
    shard).  The sharded call's launches are added to ``total``."""
    want, one = _launched(unsharded, *args, **kw)
    got, own = _launched(sharded, *args, mesh=mesh, **kw)
    _equal(what, got, want)
    if on_card and not one:
        raise AssertionError(f"{what}: the unsharded op launched no kernel")
    if own != {k: v * mesh.size for k, v in one.items()}:
        raise AssertionError(f"{what}: the sharded call launched {own}, "
                             f"not {mesh.size} x {one}")
    for k, v in own.items():
        total[k] = total.get(k, 0) + v


def check(args) -> dict[str, int]:
    """Every wrapper on every grid of ``args`` against the unsharded op
    (``torch.equal`` outputs, one launch a shard for each unsharded
    launch); raises AssertionError on a difference.  Returns the kernel
    launches that the sharded calls alone made."""
    import numpy as np

    from repro_torch.core import lfsr
    from repro_torch.core.bitpack import as_words

    dev = torch.device(args.device)
    rng = np.random.default_rng(0x22A)
    n, w, t, b = args.neurons, args.words, args.steps, args.batch
    weights = as_words(rng.integers(0, 2**32, (n, w), dtype=np.uint32), dev)
    trains = as_words(rng.integers(0, 2**32, (b, t, w), dtype=np.uint32),
                      dev)
    v = torch.zeros((n,), dtype=torch.int32, device=dev)
    teach = torch.from_numpy(
        rng.integers(-50, 50, (n,), dtype=np.int32)).to(dev)
    st = lfsr.seed(7, n * w, device=dev).reshape(n, w)
    kw = dict(threshold=60, leak=4, w_exp=64, gain=4, n_syn=w * 32,
              ltp_prob=200)
    inten = torch.from_numpy(
        rng.integers(0, 256, (b, w * 32), dtype=np.uint8)).to(dev)
    seeds = torch.arange(1, b + 1, dtype=torch.int32, device=dev)
    tt = torch.tensor([t - (i % 3) for i in range(b)], dtype=torch.int32,
                      device=dev)
    wts_b = as_words(rng.integers(0, 2**32, (b, n, w), dtype=np.uint32), dev)
    vb = torch.zeros((b, n), dtype=torch.int32, device=dev)
    tb = torch.from_numpy(
        rng.integers(-50, 50, (b, n), dtype=np.int32)).to(dev)
    stb = torch.stack([lfsr.seed(3 + i, n * w, device=dev).reshape(n, w)
                       for i in range(b)])
    backend = args.backend
    on_card = backend == "kernel" and (
        torch.device(args.on).type if args.on is not None
        else dev.type) == "cuda"
    total: dict[str, int] = {}

    for mesh in _meshes(args):
        label = _mesh_label(mesh)

        cmp = functools.partial(_compare, mesh=mesh, on_card=on_card,
                                total=total, backend=backend)
        cmp("infer_window_batch", sharded_infer_window_batch,
            ops.infer_window_batch, weights, trains, threshold=60, leak=4)
        print(f"infer_window_batch: sharded({label}) == single-device "
              f"[B={b}, n={n}]")

        for train in (True, False):
            cmp("fused_snn_window", sharded_fused_snn_window,
                ops.fused_snn_window, weights, trains[0], v, st, teach,
                train=train, **kw)
            print(f"fused_snn_window(train={train}): sharded({label}) "
                  f"== single-device [n={n}, T={t}]")

        cmp("train_window_batch", sharded_train_window_batch,
            ops.train_window_batch, wts_b, trains, vb, stb, tb, **kw)
        print(f"train_window_batch: sharded({label}) == single-device "
              f"[B={b}]")

        # in-kernel encode: every shard regenerates the same spikes from
        # its samples' seeds (stateless counter draw)
        cmp("infer_window_batch_encode", sharded_infer_window_batch_encode,
            ops.infer_window_batch_encode, weights, inten, seeds,
            n_steps=t, threshold=60, leak=4, t_total=tt)
        print(f"infer_window_batch_encode: sharded({label}) == "
              f"single-device [B={b}, ragged T]")

        for train in (True, False):
            cmp("fused_snn_window_encode", sharded_fused_snn_window_encode,
                ops.fused_snn_window_encode, weights, inten[0], 7, v, st,
                teach, n_steps=t, train=train, **kw)
            print(f"fused_snn_window_encode(train={train}): "
                  f"sharded({label}) == single-device")

        cmp("train_window_batch_encode", sharded_train_window_batch_encode,
            ops.train_window_batch_encode, wts_b, inten, seeds, vb, stb, tb,
            n_steps=t, **kw)
        print(f"train_window_batch_encode: sharded({label}) == "
              f"single-device [B={b}]")

        # the stream form: 3 samples of every stream, one launch a shard
        x3 = inten[None].expand(3, -1, -1)
        t3 = tb[None].expand(3, -1, -1)
        s3 = torch.arange(3, dtype=torch.int32, device=dev) + 11
        skw = {k: x for k, x in kw.items() if k != "ltp_prob"}
        cmp("train_stream_batch_encode", sharded_train_stream_batch_encode,
            ops.train_stream_batch_encode, wts_b, x3, s3, stb, t3,
            n_steps=t, ltp_prob=seeds * 100, **skw)
        print(f"train_stream_batch_encode: sharded({label}) == "
              f"single-device [B={b}, N=3]")
    print(f"sharded launches: {total}")
    print("OK")
    return total


def _bench(args) -> int:
    """Time sharded vs unsharded serving; print one parseable line.

    With ``--mesh-shape D,N`` it instead times the batched training grid
    on the 2-D grid against the 1-D neuron grid of the same device count
    (``BENCH2D`` line).  On one card (``--on``) every shard runs there
    in turn, so the times show the cost of d x n launches, not a
    speed-up.
    """
    import time as _time

    import numpy as np

    from repro_torch.core import lfsr
    from repro_torch.core.bitpack import as_words

    dev = torch.device(args.device)
    rng = np.random.default_rng(5)
    n, w, t, b = args.neurons, args.words, args.steps, args.batch

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize()

    def med_us(fn, *operands):
        for _ in range(2):
            fn(*operands)
            sync()
        ts = []
        for _ in range(5):
            t0 = _time.perf_counter()
            fn(*operands)
            sync()
            ts.append(_time.perf_counter() - t0)
        return float(np.median(ts) * 1e6)

    shapes = _parse_mesh_shapes(args.mesh_shape)
    if shapes:
        wts = as_words(rng.integers(0, 2**32, (b, n, w), dtype=np.uint32),
                       dev)
        spk = as_words(rng.integers(0, 2**32, (b, t, w), dtype=np.uint32),
                       dev)
        vb = torch.zeros((b, n), dtype=torch.int32, device=dev)
        tb = torch.zeros((b, n), dtype=torch.int32, device=dev)
        stb = torch.stack([lfsr.seed(1 + i, n * w, device=dev).reshape(n, w)
                           for i in range(b)])
        kw = dict(threshold=192, leak=16, w_exp=128, gain=4,
                  n_syn=w * 32, ltp_prob=16, backend=args.backend)
        for dd, nd in shapes:
            f1 = functools.partial(
                sharded_train_window_batch,
                mesh=snn_mesh(dd * nd, _devices_for(args, dd * nd)), **kw)
            f2 = functools.partial(
                sharded_train_window_batch,
                mesh=snn_mesh2d(dd, nd, _devices_for(args, dd * nd)), **kw)
            t_1, t_2 = (med_us(f, wts, spk, vb, stb, tb) for f in (f1, f2))
            print(f"BENCH2D shape={dd}x{nd} b={b} n={n} words={w} "
                  f"t_1d_us={t_1:.2f} t_2d_us={t_2:.2f}")
        return 0

    n_dev = _n_devices(args)
    mesh = snn_mesh(n_dev, _devices_for(args, n_dev))
    d = mesh.shape[_AXIS]
    weights = as_words(rng.integers(0, 2**32, (n, w), dtype=np.uint32), dev)
    trains = as_words(rng.integers(0, 2**32, (b, t, w), dtype=np.uint32),
                      dev)
    single = functools.partial(ops.infer_window_batch, threshold=192,
                               leak=16, backend=args.backend)
    shard = functools.partial(sharded_infer_window_batch, threshold=192,
                              leak=16, backend=args.backend, mesh=mesh)
    t_1, t_d = med_us(single, weights, trains), med_us(shard, weights,
                                                       trains)
    print(f"BENCH devices={d} n={n} words={w} t_single_us={t_1:.2f} "
          f"t_shard_us={t_d:.2f}")
    return 0


def parse_args(argv: list[str] | None = None):
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--devices", type=int, default=None,
                    help="1-D grid size (default: the visible cards; 8 "
                         "with --on or --device cpu)")
    ap.add_argument("--mesh-shape", action="append", default=None,
                    metavar="D,N",
                    help="2-D (data x neuron) factorization; repeatable "
                         "— each D,N grid is checked in turn")
    ap.add_argument("--neurons", type=int, default=264)
    ap.add_argument("--words", type=int, default=25)
    ap.add_argument("--steps", type=int, default=16)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--backend", default="kernel", choices=["kernel", "ref"])
    ap.add_argument("--device", default="cuda",
                    help="where the inputs and the unsharded op run "
                         "(cuda needs a card; cpu runs the plain "
                         "versions on a grid of the CPU repeated)")
    ap.add_argument("--on", default=None, metavar="DEVICE",
                    help="put every shard of the grid on this one device")
    ap.add_argument("--check", action="store_true",
                    help="assert sharded == unsharded and exit")
    ap.add_argument("--bench", action="store_true",
                    help="time sharded vs unsharded and exit")
    return ap.parse_args(argv)


def main(argv: list[str] | None = None) -> int:
    args = parse_args(argv)
    from repro_torch.engine import resolve_device
    dev = resolve_device(args.device)
    if args.on is not None:
        resolve_device(args.on)
    print(f"devices: {len(visible_devices())} cuda visible; inputs on "
          f"{dev}; shards on "
          f"{args.on or ('cpu' if dev.type == 'cpu' else 'the cards')}")
    if args.bench:
        return _bench(args)
    check(args)
    return 0


if __name__ == "__main__":
    sys.exit(main())
