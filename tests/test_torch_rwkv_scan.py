"""RWKV6's per-token recurrence as the JAX package's scan.

The port's ``recurrence`` runs through ``models.layers.scan`` (one
step's ``k_t^T v_t`` at a time, per-step inputs from one ``unbind``):
its gradients and the blocked form's against ``jax.grad`` of the JAX
layer, the traffic of both forms linear in T, and the dry run's count of
the loop by its trip count equal to a trace of every step.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from lm_train_helpers import TOL
from repro.models.layers import rwkv6 as jrwkv
from repro_torch.configs import get_config, reduced
from repro_torch.configs.shapes import ShapeSpec
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import fake_world
from repro_torch.launch.op_cost import OpCost
from repro_torch.models.layers import rwkv6

TINY = {"train": ShapeSpec("tiny_train", 32, 8, "train"),
        "prefill": ShapeSpec("tiny_prefill", 32, 4, "prefill")}


def _layer(d=64, hs=16, seed=0):
    """A JAX layer's params with decays near 1 and near 0 (so the state
    and the bonus both count), and the port's config."""
    jcfg = jrwkv.RWKV6Config(d_model=d, head_size=hs)
    params = jrwkv.init(jax.random.key(seed), jcfg, jnp.float32)
    rng = np.random.default_rng(seed)
    params = dict(params, decay_base=jnp.asarray(
        rng.standard_normal(d).astype(np.float32) * 2.0 - 1.0))
    return jcfg, rwkv6.RWKV6Config(d_model=d, head_size=hs), params


@pytest.mark.parametrize("t,chunk", [(37, 0), (64, 16)])
def test_layer_gradients_match_jax(t, chunk):
    """Params' and input's gradients of a random projection of the
    layer's output, unchunked off the chunk grid (T 37) and blocked (T
    64, chunk 16), against ``jax.grad`` of the JAX layer's same form."""
    jcfg, cfg, params = _layer()
    rng = np.random.default_rng(t)
    x = rng.standard_normal((2, t, 64)).astype(np.float32)
    ct = rng.standard_normal((2, t, 64)).astype(np.float32)

    def jloss(p, xx):
        y = (jrwkv.forward_chunked(p, xx, jcfg, chunk=chunk) if chunk
             else jrwkv.forward(p, xx, jcfg))
        return jnp.sum(y * ct)

    jgp, jgx = jax.grad(jloss, argnums=(0, 1))(params, jnp.asarray(x))
    tp = {k: torch.from_numpy(np.asarray(v, np.float32).copy())
          .requires_grad_() for k, v in params.items()}
    tx = torch.from_numpy(x).requires_grad_()
    y = (rwkv6.forward_chunked(tp, tx, cfg, chunk=chunk) if chunk
         else rwkv6.forward(tp, tx, cfg))
    (y * torch.from_numpy(ct)).sum().backward()
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jgx), **TOL)
    for k, v in tp.items():
        np.testing.assert_allclose(v.grad.numpy(), np.asarray(jgp[k]),
                                   err_msg=k, **TOL)


class _OutputBytes(TorchDispatchMode):
    """Every op's output bytes, and the largest output's elements."""

    def __init__(self):
        super().__init__()
        self.bytes = 0
        self.largest = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for o in (out if isinstance(out, (list, tuple)) else [out]):
            if isinstance(o, torch.Tensor):
                self.bytes += o.numel() * o.element_size()
                self.largest = max(self.largest, o.numel())
        return out


def _recurrence_loss(t, b=1, h=2, n=16):
    g = torch.Generator().manual_seed(t)
    r, k, v = (torch.randn((b, t, h, n), generator=g).requires_grad_()
               for _ in range(3))
    w = torch.rand((b, t, h, n), generator=g).requires_grad_()
    u = torch.randn((h, n), generator=g).requires_grad_()
    state = torch.zeros((b, h, n, n))
    return lambda: rwkv6.recurrence(r, k, v, w, u, state)[0].sum()


def _chunked_loss(t, b=1, h=2, n=16):
    cfg = rwkv6.RWKV6Config(d_model=h * n, head_size=n, decay_rank=8)
    g = torch.Generator().manual_seed(t)
    p = {k: v.requires_grad_()
         for k, v in rwkv6.init(g, cfg, torch.float32).items()}
    x = torch.randn((b, t, h * n), generator=g).requires_grad_()
    return lambda: rwkv6.forward_chunked(p, x, cfg, chunk=4).sum()


def _written(make, t) -> tuple[int, int]:
    """(bytes every op of the forward and backward writes, the largest
    output's elements)."""
    loss = make(t)
    with _OutputBytes() as m:
        loss().backward()
    return m.bytes, m.largest


@pytest.mark.parametrize("make", [_recurrence_loss, _chunked_loss],
                         ids=["recurrence", "forward_chunked"])
def test_forward_and_backward_bytes_are_linear_in_t(make):
    """Forward and backward at T 64 and 128 (B 1, H 2, N 16; chunks of
    4): the bytes every op writes grow at most 2.2x, and no op forms a
    [B, T, H, N, N] tensor (a per-step or per-chunk slice's backward
    writes a zero tensor of the whole sequence: T^2 / chunk)."""
    seen = {}
    for t in (64, 128):
        seen[t], largest = _written(make, t)
        assert largest < t * 2 * 16 * 16, (t, largest)
    assert seen[128] <= 2.2 * seen[64], seen


@pytest.mark.parametrize("t", [4, 5, 37])
@pytest.mark.parametrize("grad", [True, False])
def test_trip_count_counts_the_recurrence_as_every_step(t, grad):
    """``recurrence`` alone on meta tensors: FLOPs and bytes counted by
    the trip count equal a trace of every step, forward (and backward)."""
    counts = []
    for trip_count in (True, False):
        with OpCost(trip_count=trip_count) as c:
            r, k, v, w = (torch.empty((2, t, 3, 8), device="meta",
                                      requires_grad=grad) for _ in range(4))
            u = torch.empty((3, 8), device="meta", requires_grad=grad)
            state = torch.zeros((2, 3, 8, 8), device="meta")
            o, _ = rwkv6.recurrence(r, k, v, w, u, state)
            if grad:
                o.sum().backward()
        counts.append((c.flops, c.bytes))
    assert counts[0] == counts[1]


@pytest.fixture
def world8():
    """A fake group of 8 ranks and its (2, 4) mesh."""
    from torch.distributed.device_mesh import init_device_mesh

    with fake_world(8):
        yield init_device_mesh("cpu", (2, 4), mesh_dim_names=("data", "model"))


@pytest.mark.parametrize("kind", ["train", "prefill"])
def test_dry_run_counts_the_loop_by_its_trip_count(world8, monkeypatch,
                                                   kind):
    """Reduced rwkv6 cells on (2, 4), traced with the loop counted by its
    trip count (the dry run's default) and with every step traced:
    FLOPs, HBM bytes and collective bytes by kind and axis equal, the
    traced peak within 1%."""
    cfg = reduced(get_config("rwkv6-7b"))
    res = {}
    for trip_count in (True, False):
        monkeypatch.setattr(dryrun, "OpCost",
                            functools.partial(OpCost, trip_count=trip_count))
        res[trip_count] = dryrun.lower_cell("rwkv6-7b", TINY[kind],
                                            mesh=world8, cfg=cfg)
    got, want = res[True], res[False]
    assert got["status"] == want["status"] == "ok"
    for key in ("flops_per_chip", "hbm_bytes_per_chip",
                "collective_bytes_per_chip", "coll_breakdown",
                "coll_by_axis"):
        assert got["roofline"][key] == want["roofline"][key], key
    assert got["collectives"] == want["collectives"]
    peak, want_peak = (got["peak_bytes_per_device"],
                       want["peak_bytes_per_device"])
    assert abs(peak - want_peak) <= 0.01 * want_peak, (peak, want_peak)


@pytest.mark.parametrize("arch", ["rwkv6-7b", "mixtral-8x22b",
                                  "jamba-1.5-large-398b"])
def test_decode_of_one_sequence_runs_on_model_slices(world8, arch):
    """A decode step of a batch of one (``long_500k``'s) on (2, 4): the
    token's embedding comes split on d over data and partial over model,
    and the tensor-parallel layers take it whole."""
    cfg = reduced(get_config(arch))
    res = dryrun.lower_cell(arch, ShapeSpec("one", 64, 1, "decode"),
                            mesh=world8, cfg=cfg)
    assert res["status"] == "ok"
    assert res["roofline"]["coll_by_axis"].get("model")


if __name__ == "__main__":
    # the bytes the forward and backward write, by form and T
    for make in (_recurrence_loss, _chunked_loss):
        print(make.__name__, {t: _written(make, t) for t in (64, 128)})
