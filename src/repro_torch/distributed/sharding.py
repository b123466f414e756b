"""Logical-axis sharding: models annotate tensors with logical names;
a rules table maps them to mesh axes (or None: replicated).

The port of the JAX package's ``repro.distributed.sharding``.  Models
call ``constrain(x, "batch", "seq", "embed")`` at layer boundaries;
outside a ``use_mesh`` context this is the identity, inside it
``redistribute``s a DTensor to the placements the rules give, so the
same model code runs on one device (tests) and SPMD over a
``torch.distributed`` ``DeviceMesh`` (dry run, production) without
edits.

A resolved spec is a tuple with one entry per tensor dim: the mesh axis
that splits it, a tuple of mesh axes (split over all of them, the first
outermost), or None.  :func:`placements` turns it into DTensor
placements, one per mesh dim: ``Shard(d)`` where tensor dim ``d`` names
that mesh axis, ``Replicate()`` elsewhere.  A dim split over ("pod",
"data") takes ``Shard(d)`` on both mesh dims; DTensor splits it in
mesh-dim order, which is the tuple's order for every rule below (the
production meshes order their axes pod, data, model).

The rules are plain dicts, so the dry run swaps whole strategies per
architecture x shape (heads-TP against sequence-parallel attention; see
``SEQPAR_RULES_OVERRIDES`` and ``repro_torch.launch.dryrun``).  The SNN
window engine's rules ("neurons", "syn_words", "data") resolve on a
:class:`~repro_torch.distributed.snn_mesh.SNNMesh` grid the same way.

Under a mesh the model's parameters are DTensors.  Pointwise ops, norms
and the residual stream go through DTensor's own rules; the ops whose
rules differ between torch versions run on each rank's local tensors
with their placements (and their gradients' placements) set here by
hand: :func:`matmul`, :func:`lookup`, :func:`summed_over_rows`,
:func:`along_whole_dim`, and :class:`TensorParallel` for the layers
that split their channels over ``model`` (MoE experts' ``d_ff``, Mamba
channels, RWKV6 heads).  :func:`gathered` is the FSDP gather of a
parameter at its use.

A mesh here is a ``DeviceMesh`` (axis names ``mesh_dim_names``), an
``SNNMesh``, or anything with a ``shape`` mapping axis name to size (as
``jax.sharding.Mesh.shape``).
"""

from __future__ import annotations

import contextlib
import threading
from contextlib import contextmanager

import torch
import torch.distributed._functional_collectives as funcol
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.distributed.tensor.experimental import implicit_replication

_state = threading.local()

# Logical axis -> mesh axis (str | tuple | None).
DEFAULT_RULES: dict = {
    # activations
    "batch": ("pod", "data"),
    "seq": None,              # input token sequence axis
    "res_seq": "model",       # residual-stream seq axis (Megatron-SP)
    "mix_seq": None,          # seq axis of matmul inputs: gathered for
                              # heads-TP, model-sharded for seq-parallel
    "embed": None,
    "heads": "model",
    "kv_heads": None,
    "head_dim": None,
    "qkv": "model",           # fused qkv output dim (heads packed)
    "ffn": "model",
    "experts": None,
    "vocab": "model",         # logits vocab axis
    "kv_seq": "model",        # decode KV-cache sequence axis
    "frames": None,
    # parameters (FSDP-style: second axis over data where large)
    "p_vocab": ("pod", "data"),
    "p_embed": "model",
    "p_in": ("pod", "data"),  # contracting dim of weight matrices
    "p_out": "model",         # output dim (heads/ffn packed)
    "p_experts": None,
    "layers": None,           # the JAX package's stacked-layer axis
    # SNN window engine (repro_torch.distributed.snn_mesh): neuron rows
    # split over "neuron", each row's packed synapse words stay whole,
    # samples/streams split over "data" (replicated on a 1-D grid)
    "neurons": "neuron",
    "syn_words": None,
    "data": "data",
}

# Sequence-parallel attention: for archs whose head count does not
# divide the model axis (see repro_torch.launch.dryrun.rules_for).
SEQPAR_RULES_OVERRIDES: dict = {
    "heads": None,
    "qkv": None,
    "seq": "model",
    "res_seq": "model",
    "mix_seq": "model",
    "p_out": "model",  # weights still shard on the packed output dim
}


def use_rules(base: dict | None = None, **overrides) -> dict:
    r = dict(DEFAULT_RULES if base is None else base)
    r.update(overrides)
    return r


@contextmanager
def use_mesh(mesh, rules: dict | None = None):
    """Within the block, ``constrain`` and the model's placement follow
    ``mesh`` and ``rules`` (default ``DEFAULT_RULES``).  Per thread."""
    prev = getattr(_state, "ctx", None)
    _state.ctx = (mesh, dict(DEFAULT_RULES if rules is None else rules))
    try:
        yield
    finally:
        _state.ctx = prev


def current_mesh() -> tuple | None:
    """(mesh, rules) of the innermost ``use_mesh``, or None."""
    return getattr(_state, "ctx", None)


def replicating():
    """Inside ``use_mesh``: ``implicit_replication()``, so that a plain
    tensor that code makes for itself (positions, masks, a loss's pads
    and sums) is taken as a replicated DTensor where it meets a sharded
    one.  Such a tensor is a function of the shapes alone, the same on
    every rank, so replication is its true placement.  Without a mesh,
    or within an outer one: nothing (``implicit_replication`` turns the
    switch off when it exits, not back to what it was, so it must not
    nest)."""

    if (current_mesh() is None
            or DTensor._op_dispatcher._allow_implicit_replication):
        return contextlib.nullcontext()
    return implicit_replication()


def scoped(fn):
    """``fn`` run under the mesh, rules and :func:`replicating` of the
    caller that makes it, wherever it is called from later (a
    checkpoint's recompute runs in the backward, outside them)."""
    ctx = current_mesh()
    if ctx is None:
        return fn

    def run(*args, **kwargs):
        with use_mesh(*ctx), replicating():
            return fn(*args, **kwargs)
    return run


def is_dtensor(x) -> bool:
    return isinstance(x, DTensor)


def axis_sizes(mesh) -> dict:
    """Axis name -> size, in the mesh's axis order."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return dict(zip(names, tuple(mesh.shape)))
    return dict(mesh.shape)


def _resolve(rules: dict, mesh, names: tuple) -> tuple:
    sizes = axis_sizes(mesh)
    axes = []
    used: set = set()
    for nm in names:
        ax = rules.get(nm) if nm is not None else None
        if ax is None:
            axes.append(None)
            continue
        cand = ax if isinstance(ax, tuple) else (ax,)
        # keep only axes present in this mesh and not already used
        cand = tuple(a for a in cand if a in sizes and a not in used)
        used.update(cand)
        axes.append(cand if len(cand) > 1 else (cand[0] if cand else None))
    return tuple(axes)


def logical_spec(names: tuple, mesh=None, rules: dict | None = None
                 ) -> tuple:
    """The spec of a tensor whose dims carry the logical ``names`` on
    ``mesh`` under ``rules``: per dim the mesh axis (or axes) that split
    it, or None.  A mesh axis the mesh lacks resolves to None, and no
    mesh axis splits two dims.  ``mesh`` None: the ``use_mesh``
    context's mesh and rules (raises without one); ``rules`` None with
    a mesh given: ``DEFAULT_RULES``."""
    if mesh is None:
        ctx = current_mesh()
        if ctx is None:
            raise RuntimeError("no active mesh; use use_mesh(...)")
        mesh, ctx_rules = ctx
        rules = ctx_rules if rules is None else rules
    return _resolve(DEFAULT_RULES if rules is None else rules, mesh,
                    tuple(names))


def spec_axes(ax) -> tuple:
    """The mesh axes of one spec entry: () for None."""
    if ax is None:
        return ()
    return ax if isinstance(ax, tuple) else (ax,)


def _divisible(mesh, spec: tuple, shape: tuple) -> bool:
    sizes = axis_sizes(mesh)
    for dim, ax in zip(shape, spec):
        if ax is None:
            continue
        n = 1
        for a in spec_axes(ax):
            n *= sizes[a]
        if dim % n != 0:
            return False
    return True


def fit_spec(mesh, spec: tuple, shape: tuple) -> tuple:
    """``spec`` with every entry whose mesh axes do not divide its dim
    dropped (replicated), as the JAX package drops them."""
    if _divisible(mesh, spec, shape):
        return tuple(spec)
    return tuple(ax if ax is not None and _divisible(
        mesh, (None,) * i + (ax,), shape) else None
        for i, ax in enumerate(spec))


def spec_placements(mesh, spec: tuple) -> list:
    """A resolved spec -> DTensor placements, one per mesh dim.  A mesh
    dim of one rank replicates (a split over one rank is none, and DTensor
    refuses views that fold a dim sharded so)."""

    out = []
    for name, size in axis_sizes(mesh).items():
        dims = [d for d, ax in enumerate(spec) if name in spec_axes(ax)]
        out.append(Shard(dims[0]) if dims and size > 1 else Replicate())
    return out


def placement_spec(mesh, placements) -> tuple:
    """DTensor placements (``Shard`` / ``Replicate``) -> the resolved
    spec, for a tensor of ``ndim`` = the largest sharded dim + 1 at
    least; the inverse of :func:`spec_placements` (trailing dims that no
    mesh axis splits are left out)."""
    names = list(axis_sizes(mesh))
    per_dim: dict = {}
    for name, p in zip(names, placements):
        d = getattr(p, "dim", None)
        if d is not None:
            per_dim.setdefault(d, []).append(name)
    n = max(per_dim, default=-1) + 1
    return tuple(None if d not in per_dim else
                 (per_dim[d][0] if len(per_dim[d]) == 1 else
                  tuple(per_dim[d])) for d in range(n))


def placements(mesh, rules: dict, names: tuple, shape: tuple | None = None
               ) -> list:
    """The DTensor placements of a tensor with the logical ``names``
    (the JAX package's ``named_sharding``); with ``shape``, entries that
    do not divide their dim are dropped first."""
    spec = _resolve(rules, mesh, tuple(names))
    if shape is not None:
        spec = fit_spec(mesh, spec, tuple(shape))
    return spec_placements(mesh, spec)


def local_block(shape: tuple, mesh, placements) -> tuple:
    """(local shape, global offset) of this rank's shard of a tensor of
    ``shape`` under ``placements`` that divide their dims evenly (as
    every placement here does), read from the rank's mesh coordinate
    alone (no tensor op: it runs under a fake tensor mode too)."""
    size, off = list(shape), [0] * len(shape)
    coord = mesh.get_coordinate()
    for i, p in enumerate(placements):
        d = getattr(p, "dim", None)
        if d is None:
            continue
        n = mesh.size(i)
        if size[d] % n:
            raise ValueError(f"dim {d} of {tuple(shape)} does not split "
                             f"evenly over mesh dim {i} of size {n}")
        size[d] //= n
        off[d] += coord[i] * size[d]
    return tuple(size), tuple(off)


def as_dtensor(x: torch.Tensor, mesh):
    """``x`` as a DTensor on ``mesh``: a DTensor as it is, a plain
    tensor taken as replicated (the same value on every rank)."""

    if isinstance(x, DTensor):
        return x
    return DTensor.from_local(x, mesh, [Replicate()] * mesh.ndim,
                              run_check=False)


def gathered(w: torch.Tensor) -> torch.Tensor:
    """A parameter as a layer computes with it: a DTensor all-gathered
    over the mesh axes the rules put the batch on (its FSDP storage
    split), its other splits kept (the backward reduce-scatters the
    gradient back); a plain tensor, or no mesh: ``w`` itself."""
    ctx = current_mesh()

    if ctx is None or not isinstance(w, DTensor):
        return w
    mesh, rules = ctx
    dp = set(spec_axes(_resolve(rules, mesh, ("batch",))[0]))
    want = [Replicate() if name in dp else p
            for name, p in zip(axis_sizes(mesh), w.placements)]
    if want == list(w.placements):
        return w
    return w.redistribute(mesh, want)


def matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` for activations [..., d] and a weight [d, f].  Under a
    mesh (either a DTensor) each rank multiplies its local tensors and
    the result is placed by hand, mesh dim by mesh dim:

    * ``x`` split on a row dim: the weight gathered there; the result
      split alike (the weight's gradient partial there);
    * ``x`` split on d: the weight split on d too; the result partial;
    * ``x`` whole, the weight split on f: the result split on f (the
      activations' gradient partial); split on d: ``x`` split on d too;
    * both whole: whole.

    DTensor's own rule flattens the row dims with a view, which some
    versions refuse for two split dims, forward or backward.  Plain
    tensors: ``x @ w``."""

    if not isinstance(x, DTensor) and not isinstance(w, DTensor):
        return x @ w
    mesh = (x if isinstance(x, DTensor) else w).device_mesh
    x, w = as_dtensor(x, mesh), as_dtensor(w, mesh)
    last = x.ndim - 1
    rep = Replicate()
    xs, ws, outs, gxs, gws = [], [], [], [], []
    for m, (px, pw) in enumerate(zip(x.placements, w.placements)):
        if mesh.size(m) == 1 or px.is_partial():
            px = rep
        if px.is_shard() and px.dim < last:        # rows split
            xs.append(px), ws.append(rep), outs.append(Shard(px.dim))
            gxs.append(px), gws.append(Partial())
        elif px.is_shard() or pw.is_shard(0):      # d split
            xs.append(Shard(last)), ws.append(Shard(0)), outs.append(
                Partial())
            gxs.append(Shard(last)), gws.append(Shard(0))
        elif pw.is_shard(1):                       # f split
            xs.append(rep), ws.append(pw), outs.append(Shard(last))
            gxs.append(Partial()), gws.append(pw)
        else:
            xs.append(rep), ws.append(rep), outs.append(rep)
            gxs.append(rep), gws.append(rep)
    x_l = x.redistribute(mesh, xs).to_local(grad_placements=gxs)
    w_l = w.redistribute(mesh, ws).to_local(grad_placements=gws)
    return DTensor.from_local(x_l @ w_l, mesh, outs, run_check=False)


class TensorParallel:
    """One rank's part of a layer that splits its channels over the mesh
    axis of ``p_out`` (``model``): MoE experts' ``d_ff``, Mamba's
    channels, RWKV6's heads, as the JAX package places their weights.

    Built from the layer's input ``x``.  Inside, the layer computes on
    plain local tensors: its rows of ``x`` (the batch's split kept,
    whole over ``model``: gathered there where a sequence-parallel rule
    splits the sequence; whole over any other axis that splits it
    otherwise or holds its partial sums), each weight's block on this
    rank's ``model`` index (gathered over the other axes at use, as FSDP
    gathers), and
    the few collectives of tensor parallelism, all over ``model``:

    * :meth:`copy`: the identity, its gradient summed (a whole tensor
      that column-split products read);
    * :meth:`reduce`: a row-split product's partial sums summed, for a
      column-split product to read;
    * :meth:`regroup_halves`: the all-to-all that turns this rank's
      contiguous block of ``[a | b]`` into its blocks of ``a`` and ``b``;
    * :meth:`gather_rows`: a small tensor (MoE routing) of every rank's
      rows, and :meth:`sum_rows`, a sum over them.

    Every local gradient is the whole gradient of its tensor (the sums
    are made by ``copy`` and ``reduce``, or declared partial on the
    weights), so the weights' gradients come back placed as the weights.
    :meth:`out` returns the layer's result as a DTensor, partial over
    ``model`` as :func:`matmul`'s row-split product is; caches stay in
    each rank's shard (:meth:`cache`, :meth:`cache_local`), never
    gathered.  With a plain ``x`` (no mesh) every method is the
    identity, and on a mesh whose dims have one rank each the layer runs
    the unsharded ops on the same tensors.
    """

    def __init__(self, x: torch.Tensor):
        self.mesh = x.device_mesh if isinstance(x, DTensor) else None
        self.n, self.rank, self.tp, self.rows = 1, 0, None, []
        if self.mesh is None:
            return
        mesh = self.mesh
        ctx = current_mesh()
        rules = ctx[1] if ctx is not None else DEFAULT_RULES
        names = list(axis_sizes(mesh))
        axes = spec_axes(_resolve(rules, mesh, ("p_out",))[0])
        if len(axes) > 1:
            raise ValueError(f"p_out over {axes}: one tensor-parallel axis")
        if axes:
            self.tp = names.index(axes[0])
            self.n = mesh.size(self.tp)
            self.rank = mesh.get_coordinate()[self.tp]
            self.group = mesh.get_group(self.tp)
        # rows split on dim 0 stay split; any other split or partial sum
        # (a decode batch of one: its embedding's d split over data) is
        # made whole
        self.pl = [p if i != self.tp and p.is_shard() and p.dim == 0
                   else Replicate() for i, p in enumerate(x.placements)]
        self.rows = [i for i, p in enumerate(self.pl) if p.is_shard()]

    def local(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's rows of ``x``, whole over ``model``."""
        if self.mesh is None:
            return x
        return x.redistribute(self.mesh, self.pl).to_local()

    def block(self, t: torch.Tensor, dim: int) -> torch.Tensor:
        """This rank's ``model`` block of a whole ``t`` along ``dim``."""
        size = t.shape[dim] // self.n
        return t.narrow(dim, self.rank * size, size) if self.n > 1 else t

    def weight(self, w: torch.Tensor, dim: int | None = None, *,
               partial: bool = False) -> torch.Tensor:
        """The parameter ``w`` as this rank computes with it: its block
        along ``dim`` on this rank's ``model`` index (raises where the
        parameter is not split so), whole (``dim`` None) otherwise;
        gathered over every other mesh axis.  Its gradient is partial
        over the axes that split the rows, and over ``model`` too where
        ``partial`` (a whole weight that the rank uses for its own
        channels only)."""
        if not isinstance(w, DTensor):
            return w if dim is None else self.block(w, dim)
        mesh = w.device_mesh
        pl = [Replicate()] * mesh.ndim
        grad = [Partial() if i in self.rows else Replicate()
                for i in range(mesh.ndim)]
        if self.tp is not None and self.n > 1:
            if dim is not None:
                if w.placements[self.tp] != Shard(dim):
                    raise ValueError(
                        f"a {tuple(w.shape)} weight placed {w.placements} "
                        f"is not split on dim {dim} over model: the layer "
                        f"runs tensor-parallel where model divides it")
                pl[self.tp] = grad[self.tp] = Shard(dim)
            elif partial:
                grad[self.tp] = Partial()
        return w.redistribute(mesh, pl).to_local(grad_placements=grad)

    def copy(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` (whole on every rank), its gradient summed over
        ``model``: the input of products split on their output dim."""
        if self.n == 1:
            return t
        return _Sum.apply(t, [self.group], False, True)

    def reduce(self, t: torch.Tensor) -> torch.Tensor:
        """Partial sums over ``model`` summed, and so is their gradient:
        the sum feeds this rank's channels only (Mamba's ``x_proj``)."""
        if self.n == 1:
            return t
        return _Sum.apply(t, [self.group], True, True)

    def regroup_halves(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` [..., 2c]: this rank's contiguous block of a last dim
        ``[a | b]`` of two halves split over ``model`` -> ``[a_j | b_j]``,
        its blocks of each half (an all-to-all over ``model``, the
        reverse in the backward)."""
        if self.n == 1:
            return t
        j, n = self.rank, self.n
        rows = t.unflatten(-1, (2, t.shape[-1] // 2)).movedim(-2, 0)
        # sub-block s of the 2n goes to rank s % n; rank j holds 2j, 2j+1
        out = _Exchange.apply(rows, self.group, n,
                              ((2 * j) % n, (2 * j + 1) % n),
                              (j // 2, (n + j) // 2))
        return out.movedim(0, -2).flatten(-2)

    def gather_rows(self, t: torch.Tensor) -> tuple:
        """(``t`` [rows, ...] of every rank that splits the rows, in
        order; the index of this rank's first row).  No gradient: for
        routing decisions."""
        if not self.rows:
            return t, 0
        full = DTensor.from_local(t.detach(), self.mesh, self.pl,
                                  run_check=False).full_tensor()
        return full, local_block(tuple(full.shape), self.mesh, self.pl)[1][0]

    def sum_rows(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` summed over the ranks that split the rows (a sum over
        the rows of each); its gradient as it is."""
        if not self.rows:
            return t
        return _Sum.apply(t, [self.mesh.get_group(i) for i in self.rows],
                          True, False)

    def out(self, y: torch.Tensor):
        """The layer's local result ``y`` [rows, ...], a row-split
        product's sums, as a DTensor partial over ``model``, its rows
        placed as the input's."""
        if self.mesh is None:
            return y
        pl = [Partial() if i == self.tp and self.n > 1 else p
              for i, p in enumerate(self.pl)]
        return DTensor.from_local(y, self.mesh, pl, run_check=False)

    def replicated(self, t: torch.Tensor):
        """``t``, the same on every rank, as a replicated DTensor."""
        return t if self.mesh is None else as_dtensor(t, self.mesh)

    def cache(self, t: torch.Tensor, dim: int | None):
        """A cache's local block (this rank's rows, its ``model`` block
        along ``dim``; ``dim`` None: whole) as a DTensor placed as
        :func:`place_cache` places it."""
        if self.mesh is None:
            return t
        return DTensor.from_local(t, self.mesh, self._cache_pl(dim),
                                  run_check=False)

    def cache_local(self, c: torch.Tensor, dim: int | None) -> torch.Tensor:
        """The local block of a cache placed as :meth:`cache` places it
        (raises otherwise: a cache is never gathered), to write in
        place."""
        if self.mesh is None:
            return c
        want = self._cache_pl(dim)
        if not isinstance(c, DTensor) or list(c.placements) != want:
            raise ValueError(f"a cache placed {getattr(c, 'placements', None)}"
                             f", not {want}: its rows as the input's, split "
                             f"on dim {dim} over model")
        return c.to_local()

    def _cache_pl(self, dim):
        return [Shard(dim) if i == self.tp and dim is not None and self.n > 1
                else p for i, p in enumerate(self.pl)]


class _Sum(torch.autograd.Function):
    """A sum over the ranks of ``groups`` in the forward (``fwd``) and in
    the backward (``bwd``); the identity where off."""

    @staticmethod
    def forward(ctx, t, groups, fwd, bwd):
        ctx.groups, ctx.bwd = groups, bwd
        return _all_reduce(t, groups) if fwd else t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        return (_all_reduce(g, ctx.groups) if ctx.bwd else g,
                None, None, None)


def _all_reduce(t: torch.Tensor, groups) -> torch.Tensor:
    for g in groups:
        t = funcol.wait_tensor(funcol.all_reduce(t.contiguous(), "sum", g))
    return t


class _Exchange(torch.autograd.Function):
    """The rows of ``t`` [2, ...]: row q to rank ``send[q]``, row q of
    the result from rank ``recv[q]`` (an all-to-all; the reverse in the
    backward)."""

    @staticmethod
    def forward(ctx, t, group, n, send, recv):
        ctx.args = (group, n, recv, send)
        return _all_to_all(t, group, n, send, recv)

    @staticmethod
    def backward(ctx, g):
        return _all_to_all(g, *ctx.args), None, None, None, None


def _all_to_all(t, group, n: int, send: tuple, recv: tuple):
    # all_to_all_single takes its input by destination rank and gives its
    # output by source rank
    by_dest = sorted(range(2), key=lambda q: send[q])
    if by_dest != [0, 1]:
        t = t[by_dest]
    out = funcol.wait_tensor(funcol.all_to_all_single(
        t.contiguous(), [recv.count(r) for r in range(n)],
        [send.count(r) for r in range(n)], group))
    src = sorted(recv)
    if src != list(recv):
        out = out[[src.index(r) for r in recv]]
    return out


def lookup(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """``table[ids]``.  Under a mesh ``ids`` is a DTensor: each rank looks
    its ids up in the whole table (gathered) and the rows keep the ids'
    placements; the table's gradient is partial over the mesh dims that
    split the ids.  (DTensor has no sharding rule for the lookup's
    backward on every version.)"""

    if not isinstance(ids, DTensor):
        return table[ids]
    mesh = ids.device_mesh
    split = [p.is_shard() for p in ids.placements]
    t_l = as_dtensor(table, mesh).redistribute(
        mesh, [Replicate()] * mesh.ndim).to_local(
        grad_placements=[Partial() if s else Replicate() for s in split])
    return DTensor.from_local(t_l[ids.to_local()], mesh, ids.placements,
                              run_check=False)


def along_whole_dim(fn, x: torch.Tensor, dim: int) -> torch.Tensor:
    """``fn(x)`` for an ``fn`` that moves data along ``dim`` only (the
    other dims' extents kept): a DTensor ``x`` is gathered along ``dim``
    and ``fn`` runs on each rank's local tensor, its other splits kept.
    No gradient flows (serving)."""

    if not isinstance(x, DTensor):
        return fn(x)
    mesh = x.device_mesh
    pl = [Replicate() if p.is_shard(dim) else p for p in x.placements]
    return DTensor.from_local(fn(x.redistribute(mesh, pl).to_local()), mesh,
                              pl, run_check=False)


def summed_over_rows(fn, *xs) -> tuple:
    """``fn(*xs)`` -> sums (0-d), for DTensors ``xs`` placed alike and
    split on their leading (row) dims only: each rank runs ``fn`` on its
    own rows, and each sum comes back partial over the mesh dims that
    split them (a ``constrain`` with no names reduces it).  Plain
    tensors: ``fn(*xs)``."""

    if not isinstance(xs[0], DTensor):
        return fn(*xs)
    mesh, pl = xs[0].device_mesh, xs[0].placements
    sums = fn(*(x.redistribute(mesh, pl).to_local() for x in xs))
    out_pl = [Partial() if p.is_shard() else Replicate() for p in pl]
    return tuple(DTensor.from_local(t, mesh, out_pl, run_check=False)
                 for t in sums)


def constrain(x: torch.Tensor, *names):
    """Annotate ``x`` with logical axis names: the identity without a
    mesh; inside ``use_mesh``, ``x`` redistributed to the placements the
    rules give (a plain tensor is taken as replicated first), each mesh
    axis that does not divide its dim dropped rather than failing
    mid-model (the dry run shows the replicated memory it costs)."""
    ctx = current_mesh()
    if ctx is None:
        return x
    mesh, rules = ctx
    spec = fit_spec(mesh, _resolve(rules, mesh, names), tuple(x.shape))
    x = as_dtensor(x, mesh)
    want = spec_placements(mesh, spec)
    if tuple(x.placements) == tuple(want):
        return x
    return x.redistribute(mesh, want)
