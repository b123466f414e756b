"""A loop over a sequence's time axis: the port's ``lax.scan``.

``scan(body, carry, xs, consts)`` runs ``carry, y_t = body(carry, x_t,
consts)`` for t = 0 .. T-1, where ``x_t`` holds step t of each of ``xs``
(tensors ``[B, T, ...]``, taken by one ``unbind(1)`` each: the backward
is one ``stack``), and returns the final carry and the ``y_t`` stacked
on dim 1.  Each step forms only its own tensors, as the JAX package's
scan body does, so memory and the backward's traffic are linear in T.
``consts`` are the tensors every step reads (their gradients summed over
the steps); the body takes them from there, not from a closure, so that
a counted trace sees their gradients.

On a real run the loop is the plain one above.  Under the dry run's op
counter (``launch.op_cost.OpCost`` pushes itself on ``counters`` while
it counts loops by their trip count), a loop over ``meta`` tensors of
T > 3 steps traces three steps and counts the rest by the trip count,
as the JAX package's ``hlo_cost`` counts a ``while`` as ``trip_count x
body``: the first step (its carry from outside), one middle step counted
T - 2 times and the last step (its carry's gradient from outside), in
the forward and in the backward, with every other count of the plain
loop (the stack of the outputs, the stack of each input's per-step
gradients, the T - 1 sums of each const's gradient).  Memory follows
the plain loop: the other steps' outputs, saved tensors (a middle
step's, measured with ``saved_tensors_hooks``, times T, held for as long
as autograd keeps the loop's) and per-step gradients are reserved on the
counter for as long as the plain loop would hold them.
"""

from __future__ import annotations

from collections.abc import Callable, Sequence

import torch

# the op counters, innermost last, that count a loop by its trip count
counters: list = []


def scan(body: Callable, carry: torch.Tensor, xs: Sequence[torch.Tensor],
         consts: Sequence[torch.Tensor] = ()):
    """(final carry, ys [B, T, ...]); see the module docstring."""
    t = xs[0].shape[1]
    tensors = (carry, *xs, *consts)
    if counters and t > 3 and all(a.device.type == "meta" for a in tensors):
        grad = torch.is_grad_enabled() and any(a.requires_grad
                                                for a in tensors)
        return _TripCounted.apply(body, counters[-1], grad, len(xs), carry,
                                  *xs, *consts)
    ys = []
    for x_t in zip(*(x.unbind(1) for x in xs)):
        carry, y = body(carry, x_t, consts)
        ys.append(y)
    return carry, torch.stack(ys, dim=1)


def _bytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _step_inputs(carry, xs, consts, i, req):
    """Step ``i``'s inputs as leaves of a graph of their own, each
    requiring grad as ``req`` (carry, xs, consts) says."""
    return (carry.detach().requires_grad_(req[0]),
            [x.select(1, i).detach().requires_grad_(r)
             for x, r in zip(xs, req[1:])],
            [k.detach().requires_grad_(r)
             for k, r in zip(consts, req[1 + len(xs):])])


def _saved_per_step(body, cost, carry, xs, consts, req):
    """What a middle step saves for its backward: the bytes of the
    tensors it forms, and which of the loop's inputs (carry, xs,
    consts) it keeps (their storages are held already)."""
    inputs = {a.untyped_storage()._cdata: j
              for j, a in enumerate((carry, *xs, *consts))}
    formed, kept = {}, set()

    def pack(a):
        s = a.untyped_storage()
        if s._cdata in inputs:
            kept.add(inputs[s._cdata])
        else:
            formed[s._cdata] = s.nbytes()
        return a

    with (cost.scaled(0), torch.enable_grad(),
          torch.autograd.graph.saved_tensors_hooks(pack, lambda a: a)):
        body(*_step_inputs(carry, xs, consts, 1, (True, *req[1:])))
    return sum(formed.values()), sorted(kept)


class _TripCounted(torch.autograd.Function):
    """:func:`scan` on ``meta`` tensors: the first, a middle and the
    last step traced, the middle one counted T - 2 times."""

    @staticmethod
    def forward(ctx, body, cost, grad, n_xs, carry, *args):
        xs, consts = args[:n_xs], args[n_xs:]
        t = xs[0].shape[1]
        ctx.set_materialize_grads(False)
        ctx.body, ctx.cost, ctx.n_xs = body, cost, n_xs
        req = ctx.needs_input_grad[4:]
        inputs = (carry, *args)
        ctx.layout = [(a.shape, a.stride(), a.dtype) for a in inputs]
        formed, kept = (_saved_per_step(body, cost, carry, xs, consts, req)
                        if grad else (0, []))
        ys = []
        for i, times in ((0, 1), (1, t - 2), (t - 1, 1)):
            with cost.scaled(times):
                carry, y = body(carry, [x.select(1, i) for x in xs], consts)
            ys.append(y)
            if i == 1:   # the other steps' outputs, held until the stack
                release = cost.reserve((t - 3) * _bytes(y))
        out = torch.stack([ys[0]] + [ys[1]] * (t - 2) + [ys[2]], dim=1)
        if grad:
            # every step's saved tensors (each step's carry is a tensor of
            # its own, the first the loop's), for as long as autograd
            # keeps this token (a checkpointed forward lets it go at once)
            with cost.scaled(0):
                token = torch.empty(0, device="meta")
            carries = (t - 1) * _bytes(inputs[0]) if 0 in kept else 0
            cost.reserve_while(t * formed + carries, token)
            ctx.save_for_backward(*(inputs[j] for j in kept), token)
        release()
        return carry, out

    @staticmethod
    def backward(ctx, g_carry, g_ys):
        body, cost, n_xs = ctx.body, ctx.cost, ctx.n_xs
        token = ctx.saved_tensors[-1]
        req = list(ctx.needs_input_grad[4:])
        # the three steps again, each a graph of its own, not counted (on
        # meta tensors: the inputs by their layout alone)
        steps = []
        with torch.enable_grad(), cost.scaled(0):
            carry, *args = (torch.empty_strided(shape, stride, dtype=dtype,
                                                device="meta")
                            for shape, stride, dtype in ctx.layout)
            xs, consts = args[:n_xs], args[n_xs:]
            t = xs[0].shape[1]
            for i in (0, 1, t - 1):
                c_in, x_in, k_in = _step_inputs(carry, xs, consts, i, req)
                carry, y = body(c_in, x_in, k_in)
                req[0] = carry.requires_grad
                steps.append((i, c_in, x_in, k_in, carry, y))
        g_x, g_k, releases = [], [], []
        for (i, c_in, x_in, k_in, c_out, y), times in zip(reversed(steps),
                                                          (1, t - 2, 1)):
            outs = [(a, g) for a, g in ((c_out, g_carry),
                                        (y, None if g_ys is None
                                         else g_ys.select(1, i)))
                    if g is not None and a.requires_grad]
            ins = [a for a in (c_in, *x_in, *k_in) if a.requires_grad]
            gs = [None] * len(ins)
            if outs and ins:
                with torch.enable_grad(), cost.scaled(times):
                    gs = torch.autograd.grad([a for a, _ in outs], ins,
                                             [g for _, g in outs],
                                             allow_unused=True)
            gs = iter(gs)
            g_carry = next(gs) if c_in.requires_grad else None
            g_x.append([next(gs) if a.requires_grad else None for a in x_in])
            g_k.append([next(gs) if a.requires_grad else None for a in k_in])
            if i == t - 1:
                # the other steps' saved tensors go as their backward runs
                cost.release(token)
            elif i == 1:   # the other steps' gradients, held until stacked
                releases = [cost.reserve((t - 3) * _bytes(g)
                                         if g is not None else 0)
                            for g in g_x[1]]
        # each input's per-step gradients stacked as unbind's backward
        # stacks them (zeros for a step that gave none), last input first
        grads_x = [None] * n_xs
        for j in reversed(range(n_xs)):
            per_step = [(g[j], times) for g, times in zip(g_x, (1, t - 2, 1))]
            if any(g is not None for g, _ in per_step):
                last, mid, first = (_or_zeros(cost, g, xs[j], times)
                                    for g, times in per_step)
                grads_x[j] = torch.stack([first] + [mid] * (t - 2) + [last],
                                         dim=1)
            releases[j]()
        # each const's gradient summed over the steps, as autograd sums
        # a tensor's gradients (one add a step after the first)
        grads_k = []
        for j in range(len(consts)):
            acc = None
            for g, times in zip(g_k, (1, t - 2, 1)):
                if g[j] is None:
                    continue
                if acc is None:
                    acc, times = g[j], times - 1
                if times:
                    with cost.scaled(times):
                        acc = acc + g[j]
            grads_k.append(acc)
        return (None, None, None, None, g_carry, *grads_x, *grads_k)


def _or_zeros(cost, g, x, times):
    """``g``, or the zeros unbind's backward puts for a missing step
    gradient (one ``zeros`` a step, expanded)."""
    if g is not None:
        return g
    with cost.scaled(times):
        z = torch.zeros((), dtype=x.dtype, device=x.device)
    return z.expand(x.select(1, 0).shape)
