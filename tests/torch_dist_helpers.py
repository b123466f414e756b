"""Multi-rank checks of the port's sharded LM path, on gloo ranks.

    python tests/torch_dist_helpers.py OUT_DIR [WORLD [cuda]]

spawns WORLD (default 8) ranks joined by a ``FileStore`` under OUT_DIR,
each on a (2, WORLD / 2) (data, model) ``DeviceMesh`` (gloo on the CPU;
with ``cuda``, NCCL with rank r on card r: a machine with WORLD cards),
and writes what ``tests/test_torch_dist_train.py`` asserts to
``OUT_DIR/results.json`` (rank 0) and ``OUT_DIR/psum_rank<r>.npz``:

* starcoder2-3b reduced, float32, SEQPAR rules: the first step's
  gradients, then 4 AdamW steps, sharded and unsharded from the same
  weights (losses, largest param and state gaps, the params beyond
  1e-5 counted beside their first-step gradients); the sharded params
  saved (every rank; rank 0 writes) beside an unsharded save of the
  same values;
* gemma3-1b reduced with a padded vocabulary, float32, the default
  (heads-TP) rules: the same training pair; and its sharded prefill and
  decode steps (ring caches, one length and lengths per sequence)
  against the unsharded port's logits and caches;
* ``TrainLoop`` over a sharded state on every rank, rank 0's writes
  slowed, failing at the step after an async save: the steps each rank
  ran, and its final state against a run without the failure;
* mixtral-8x22b, jamba-1.5-large and rwkv6-7b reduced, default rules:
  one step's gradient placements against the params', and the step's
  new params' placements;
* the tensor-parallel families (``check_sharded_families``): reduced
  mixtral-8x22b (default and SEQPAR rules), jamba-1.5-large and
  rwkv6-7b in float32, sharded against unsharded from the same weights:
  a prefill and 4 decode steps (logits, every cache leaf, the dropped
  (token, slot)s), one AdamW step, and the channels each rank's expert
  product, Mamba scan and RWKV6 recurrence see;
* ``compressed_psum`` over a 1-D data mesh of every rank: one step from
  per-rank numpy inputs, and the 150-step toy regression;
* ``restore_onto`` a sharded layout from a checkpoint the port wrote
  unsharded and from ``OUT_DIR/jax_ckpt`` (written by the JAX package,
  where it exists);
* on cards only: gemma3-1b at full width in bf16, 3 training steps
  sharded (heads-TP) against the same steps unsharded on rank 0's card
  (losses, step wall s, peak memory a rank); the same for one layer of
  mixtral-8x22b at full width (T 256, bf16 AdamW states), its experts'
  ``d_ff`` split over ``model``.
"""

from __future__ import annotations

import contextlib
import json
import os
import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

STEPS, BATCH, SEQ = 4, 8, 32
# params after STEPS steps are held to this; the ones beyond it counted
PARAM_TOL = 1e-5
SERVE_PROMPT, SERVE_MAX_LEN, DECODE = 24, 32, 4
LOOP_STEPS, LOOP_FAIL = 8, 5


def _train(model, rules, mesh, batches):
    """(losses, (final params, AdamW state)) of ``len(batches)`` AdamW
    steps; sharded under ``mesh`` when it is given."""

    from repro_torch.distributed import sharding as shd
    from repro_torch.distributed.specs import place_params
    from repro_torch.launch.train import make_train_step
    from repro_torch.optim import AdamW, AdamWConfig

    opt = AdamW(AdamWConfig(lr=1e-3))
    step = make_train_step(model, opt)
    ctx = (shd.use_mesh(mesh, rules) if mesh is not None
           else contextlib.nullcontext())
    with ctx:
        params = (place_params(model, mesh, rules) if mesh is not None
                  else dict(model.named_parameters()))
        state = (params, opt.init(params))
        losses = []
        for b in batches:
            p, s, m = step(*state, b)
            state = (p, s)
            losses.append(float(m["loss"]))
    return losses, state


def _full(t):
    from torch.distributed.tensor import DTensor
    return (t.full_tensor() if isinstance(t, DTensor) else t).detach()


def _train_pair(cfg, rules, mesh, dev, steps: int = STEPS
                ) -> tuple[dict, dict]:
    """``steps`` AdamW steps of ``cfg`` in float32, sharded on ``mesh``
    under ``rules`` and unsharded from the same weights: (what the test
    reads, the sharded params).  Besides the largest gaps, the params
    whose gap exceeds ``PARAM_TOL`` are counted, with the largest
    first-step gradient (unsharded) among them."""
    import torch

    from repro_torch.data import SyntheticTokens
    from repro_torch.models.transformer import Model

    src = SyntheticTokens(vocab_size=cfg.vocab_size, seq_len=SEQ,
                          batch_size=BATCH, seed=0)
    batches = [{k: torch.from_numpy(v).to(dev) for k, v in
                src.batch(i).items()} for i in range(steps)]

    def model():
        return Model(cfg, torch.float32, attn_chunk=16, loss_chunk=16,
                     device=dev, seed=0)

    want, (p_want, s_want) = _train(model(), rules, None, batches)
    got, (p_got, s_got) = _train(model(), rules, mesh, batches)
    g0, grad_gap = _first_grads(model, rules, mesh, batches[0])
    gaps = {k: (_full(p_got[k]) - p_want[k]).detach().abs()
            for k in p_want}
    over = {k: g > PARAM_TOL for k, g in gaps.items()}
    state_gap = max(float((_full(s_got[mv][k]) - s_want[mv][k]).abs().max())
                    for mv in ("m", "v") for k in p_want)
    return {"losses_sharded": got, "losses_plain": want,
            "max_param_gap": max(float(g.max()) for g in gaps.values()),
            "n_param_elements": sum(g.numel() for g in gaps.values()),
            "n_over_tol": sum(int(o.sum()) for o in over.values()),
            "max_first_grad_over_tol": max(
                (float(g0[k].abs()[o].max()) for k, o in over.items()
                 if o.any()), default=0.0),
            "state_gap": state_gap, "first_grads_gap": grad_gap}, p_got


def check_seqpar_train(mesh, out: Path, dev) -> dict:
    import torch

    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.configs import get_config, reduced
    from repro_torch.distributed import sharding as shd

    rules = shd.use_rules(**shd.SEQPAR_RULES_OVERRIDES)
    res, p_got = _train_pair(reduced(get_config("starcoder2-3b")), rules,
                             mesh, dev)
    # the sharded params saved from every rank, and the same values saved
    # unsharded (rank 0)
    full = {k: _full(v).cpu() for k, v in p_got.items()}
    CheckpointManager(out / "ckpt_sharded", async_save=False).save(
        0, p_got)
    if torch.distributed.get_rank() == 0:
        CheckpointManager(out / "ckpt_plain", async_save=False).save(
            0, full)
    res["placements"] = {k: [str(p) for p in v.placements]
                         for k, v in p_got.items()}
    return res


def _small_gemma():
    """gemma3-1b reduced (six layers, five of them windowed at 16; tied
    embeddings; 4 query heads on 1 KV head) with a vocabulary of 500,
    padded to 512: the heads-TP, ring-cache and padded-vocab routes."""
    import dataclasses

    from repro_torch.configs import get_config, reduced

    return dataclasses.replace(reduced(get_config("gemma3-1b")),
                               vocab_size=500)


def check_headstp_train(mesh, dev) -> dict:
    """:func:`_train_pair` of :func:`_small_gemma` under the default
    (heads-TP) rules: query heads and the FFN split over ``model``, the
    batch over ``data``, the tied table vocab-parallel in the loss."""
    from repro_torch.distributed import sharding as shd

    res, p_got = _train_pair(_small_gemma(), shd.use_rules(), mesh, dev)
    res["wqkv_placements"] = [str(p) for p in
                              p_got["layers.0.mixer.wqkv"].placements]
    return res


def check_sharded_serve(mesh, dev) -> dict:
    """:func:`_small_gemma` served sharded under the default rules and
    unsharded from the same weights: a 24-token prefill of 4 sequences
    (past the window of 16: the windowed layers' caches are rings) and
    ``DECODE`` decode steps of fixed tokens, once with one length
    (``make_prefill_step`` / ``make_serve_step``) and once with lengths
    per sequence.  The largest gaps of the logits (every call) and of the
    final caches."""
    import torch

    from repro_torch.distributed import sharding as shd
    from repro_torch.distributed.specs import place_params
    from repro_torch.launch.serve import make_prefill_step, make_serve_step
    from repro_torch.launch.train import bind_params
    from repro_torch.models.transformer import Model

    cfg = _small_gemma()
    rules = shd.use_rules()
    rng = np.random.default_rng(5)
    tok = torch.from_numpy(rng.integers(0, cfg.vocab_size,
                                        (4, SERVE_PROMPT))).to(dev)
    feed = torch.from_numpy(rng.integers(0, cfg.vocab_size,
                                         (DECODE, 4, 1))).to(dev)
    lengths = torch.tensor([SERVE_PROMPT, 21, SERVE_PROMPT, 18])

    def serve(model, params, per_seq):
        if per_seq:
            bind_params(model, params)
            logits, cache, n = model.prefill(tok, SERVE_MAX_LEN, lengths)
        else:
            logits, cache, n = make_prefill_step(model, SERVE_MAX_LEN)(
                params, {"tokens": tok})
        step = make_serve_step(model)
        out = [_full(logits)]
        for i in range(DECODE):
            logits, cache = step(params, feed[i], cache, n + i)
            out.append(_full(logits))
        kv = [_full(c["kv"][name]) for c in cache["decoder"]
              for name in ("k", "v")]
        return out, kv

    res = {}
    for per_seq in (False, True):
        plain = Model(cfg, torch.float32, attn_chunk=16, device=dev, seed=2)
        want, kv_want = serve(plain, dict(plain.named_parameters()),
                              per_seq)
        sharded = Model(cfg, torch.float32, attn_chunk=16, device=dev,
                        seed=2)
        with shd.use_mesh(mesh, rules):
            params = place_params(sharded, mesh, rules)
            got, kv_got = serve(sharded, params, per_seq)
        res["lengths" if per_seq else "one_length"] = {
            "logits_gap": max(float((a - b).abs().max())
                              for a, b in zip(got, want)),
            "cache_gap": max(float((a - b).abs().max())
                             for a, b in zip(kv_got, kv_want)),
            "calls": len(got),
            "pad_masked": bool((got[0][:, cfg.vocab_size:] <= -1e29).all()),
            "ring_slots": int(kv_got[0].shape[2])}
    return res


def check_trainloop_recovery(mesh, out: Path, dev) -> dict:
    """``TrainLoop`` on every rank over a sharded state, rank 0's writes
    slowed (a slow file system): a failure at the step right after an
    async save.  Every rank must restore the step rank 0 wrote last and
    end on the params of a run without the failure."""
    from unittest import mock

    import torch
    import torch.distributed as dist
    from torch.distributed.tensor import Shard, distribute_tensor

    from repro_torch.runtime import (SimulatedFailure, TrainLoop,
                                     TrainLoopConfig)

    rank = dist.get_rank()
    w0 = torch.from_numpy(np.linspace(-1, 1, 8 * 16, dtype=np.float32)
                          .reshape(8, 16)).to(dev)

    def step_fn(params, opt_state, batch, gen):
        w = 0.5 * params["w"] + batch
        m = 0.9 * opt_state["m"] + w
        return {"w": w}, {"m": m}, {"loss": (w * w).sum()}

    def batch_fn(step):
        return 0.125 * (step + 1)

    failed = []

    def fail_once(step):
        if step == LOOP_FAIL and not failed:
            failed.append(step)
            raise SimulatedFailure(f"node lost at step {step}")

    real_save = np.save

    def slow_save(*args, **kwargs):
        import time
        time.sleep(0.2)
        return real_save(*args, **kwargs)

    cfg = TrainLoopConfig(total_steps=LOOP_STEPS, checkpoint_every=2,
                          straggler_warmup=LOOP_STEPS)
    loop = TrainLoop(step_fn, cfg, str(out / "loop_ckpt"),
                     batch_fn=batch_fn, failure_hook=fail_once)
    pl = [Shard(0), Shard(1)]
    state = ({"w": distribute_tensor(w0, mesh, pl)},
             {"m": distribute_tensor(torch.zeros_like(w0), mesh, pl)})
    slow = (mock.patch.object(np, "save", slow_save) if rank == 0
            else mock.patch.object(np, "save", real_save))
    with slow:
        params, opt_state = loop.run(state)
    # the same steps, unsharded and without a failure
    p, o = {"w": w0}, {"m": torch.zeros_like(w0)}
    for step in range(LOOP_STEPS):
        p, o, _ = step_fn(p, o, batch_fn(step), None)
    logs = [None] * dist.get_world_size()
    dist.all_gather_object(logs, [m["step"] for m in loop.metrics_log])
    equal = [None] * dist.get_world_size()
    dist.all_gather_object(equal, bool(
        torch.equal(params["w"].full_tensor(), p["w"])
        and torch.equal(opt_state["m"].full_tensor(), o["m"])))
    return {"steps_by_rank": logs, "equal_by_rank": equal,
            "restarts": loop.restarts,
            "placed_as_before": list(params["w"].placements) == pl}


def _first_grads(model, rules, mesh, batch) -> tuple[dict, float]:
    """The first step's gradients unsharded, by name, and the largest
    gap between them and the sharded ones (each redistributed to its
    parameter's placements, then gathered)."""
    import torch

    from repro_torch.distributed import sharding as shd
    from repro_torch.distributed.specs import place_params
    from repro_torch.launch.train import _constrain_like_params

    m0 = model()
    p0 = dict(m0.named_parameters())
    g0 = torch.autograd.grad(m0.loss(batch), list(p0.values()))
    m1 = model()
    with shd.use_mesh(mesh, rules):
        p1 = place_params(m1, mesh, rules)
        with shd.replicating():
            g1 = torch.autograd.grad(m1.loss(batch), list(p1.values()))
            g1 = _constrain_like_params(dict(zip(p1, g1)), p1)
    return dict(zip(p0, g0)), max(float((_full(g1[k]) - g).abs().max())
                                  for k, g in zip(p0, g0))


# the tensor-parallel families: (config, rules) of each sharded run; the
# MoE configs at a capacity factor that drops (token, slot)s
MOE_CAPACITY = 0.5
FAMILIES = (("mixtral-8x22b", "default"), ("mixtral-8x22b", "seqpar"),
            ("jamba-1.5-large-398b", "default"), ("rwkv6-7b", "default"))


@contextlib.contextmanager
def _recording_local_shapes(seen: dict):
    """Records, for the block, the channels a rank's expert product
    (``d_ff``), Mamba scan (``d_inner``) and RWKV6 recurrence (heads)
    see, and each MoE routing's places of its (token, slot)s (in
    ``seen["places"]``)."""
    from repro_torch.models.layers import mamba, moe, rwkv6

    real = (moe.experts, moe.slots, mamba.scan, rwkv6.recurrence)

    def experts(params, buf):
        seen.setdefault("d_ff", params["wi"].shape[-1])
        return real[0](params, buf)

    def slots(idx, n_experts):
        onehot, pos = real[1](idx, n_experts)
        seen.setdefault("places", []).append(pos)
        return onehot, pos

    def scan(a, b):
        seen.setdefault("d_inner", a.shape[2])
        return real[2](a, b)

    def recurrence(r, *args):
        seen.setdefault("heads", r.shape[2])
        return real[3](r, *args)

    moe.experts, moe.slots = experts, slots
    mamba.scan, rwkv6.recurrence = scan, recurrence
    try:
        yield seen
    finally:
        moe.experts, moe.slots, mamba.scan, rwkv6.recurrence = real


def _family_rules(kind: str) -> dict:
    from repro_torch.distributed import sharding as shd

    return (shd.use_rules(**shd.SEQPAR_RULES_OVERRIDES) if kind == "seqpar"
            else shd.use_rules())


def _serve_family(cfg, rules, mesh, dev) -> dict:
    """``cfg`` served sharded under ``rules`` and unsharded from the same
    weights: a ``SERVE_PROMPT``-token prefill of 4 sequences and
    ``DECODE`` decode steps of fixed tokens.  The largest gaps of the
    logits (every call) and of every cache leaf after the prefill and
    after the last step (over the leaf's scale), the local channels the
    sharded run's layers saw, and whether its MoE routings dropped the
    same (token, slot)s."""
    import torch

    from repro_torch.distributed import sharding as shd
    from repro_torch.distributed.specs import map_tree, place_params
    from repro_torch.launch.serve import make_prefill_step, make_serve_step
    from repro_torch.models.layers import moe
    from repro_torch.models.transformer import Model

    rng = np.random.default_rng(11)
    tok = torch.from_numpy(rng.integers(0, cfg.vocab_size,
                                        (4, SERVE_PROMPT))).to(dev)
    feed = torch.from_numpy(rng.integers(0, cfg.vocab_size,
                                         (DECODE, 4, 1))).to(dev)

    def serve(model, params):
        logits, cache, n = make_prefill_step(model, SERVE_MAX_LEN)(
            params, {"tokens": tok})
        out = [_full(logits)]
        caches = [map_tree(lambda t: _full(t).clone(), cache)]
        step = make_serve_step(model)
        for i in range(DECODE):
            logits, cache = step(params, feed[i], cache, n + i)
            out.append(_full(logits))
        caches.append(map_tree(_full, cache))
        return out, caches

    def leaves(tree):
        out = []
        map_tree(out.append, tree)
        return out

    def drops(places):
        mcfg = plain.moe_cfg()
        return [(pos >= moe.capacity(pos.shape[0], mcfg)).tolist()
                for pos in places]

    plain = Model(cfg, torch.float32, attn_chunk=16, device=dev, seed=2)
    want_seen: dict = {}
    with _recording_local_shapes(want_seen):
        want, c_want = serve(plain, dict(plain.named_parameters()))
    sharded = Model(cfg, torch.float32, attn_chunk=16, device=dev, seed=2)
    seen: dict = {}
    with shd.use_mesh(mesh, rules), _recording_local_shapes(seen):
        got, c_got = serve(sharded, place_params(sharded, mesh, rules))
    # each cache leaf's gap over its largest magnitude where that exceeds
    # 1 (the RWKV6 state sums k v over the prompt, up to ~30 here)
    gaps = [max(float((a - b).abs().max() / max(1.0, float(b.abs().max())))
                for a, b in zip(leaves(g), leaves(w)))
            for g, w in zip(c_got, c_want)]
    return {"logits_gap": max(float((a - b).abs().max())
                              for a, b in zip(got, want)),
            "prefill_cache_gap": gaps[0], "decode_cache_gap": gaps[1],
            "calls": len(got), "cache_leaves": len(leaves(c_got[0])),
            "local": {k: v for k, v in seen.items() if k != "places"},
            "full": {k: v for k, v in want_seen.items() if k != "places"},
            "same_drops": (drops(seen.get("places", []))
                           == drops(want_seen.get("places", []))),
            "n_drops": sum(sum(map(sum, d)) for d in
                           drops(want_seen.get("places", [])))}


def check_sharded_families(mesh, dev) -> dict:
    """Reduced mixtral-8x22b (default and SEQPAR rules), jamba-1.5-large
    and rwkv6-7b in float32 (the MoE layers at ``MOE_CAPACITY``), each
    sharded against the unsharded port from the same weights: serving
    (:func:`_serve_family`) and one AdamW step (:func:`_train_pair`)."""
    import dataclasses
    import time

    import torch

    from repro_torch.configs import get_config, reduced

    out = {}
    for arch, kind in FAMILIES:
        cfg = reduced(get_config(arch))
        if cfg.n_experts:
            cfg = dataclasses.replace(cfg, capacity_factor=MOE_CAPACITY)
        rules = _family_rules(kind)
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        res = _serve_family(cfg, rules, mesh, dev)
        res["train"], _ = _train_pair(cfg, rules, mesh, dev, steps=1)
        # both runs, sharded and unsharded, on the host's clock; the peak
        # memory this rank allocated (on cards)
        res["wall_s"] = time.perf_counter() - t0
        if dev.type == "cuda":
            res["peak_bytes_rank"] = torch.cuda.max_memory_allocated(dev)
        out[f"{arch}/{kind}"] = res
    return out


def check_grad_placements(mesh, dev, arch: str = "mixtral-8x22b") -> dict:
    import torch

    from repro_torch.configs import get_config, reduced
    from repro_torch.distributed import sharding as shd
    from repro_torch.distributed.specs import place_params
    from repro_torch.launch.train import (_constrain_like_params,
                                          make_train_step)
    from repro_torch.models.transformer import Model
    from repro_torch.optim import AdamW, AdamWConfig

    cfg = reduced(get_config(arch))
    model = Model(cfg, torch.float32, attn_chunk=16, loss_chunk=16,
                  device=dev, seed=1)
    rules = shd.use_rules()
    rng = np.random.default_rng(3)
    tok = torch.from_numpy(rng.integers(0, cfg.vocab_size,
                                        (BATCH, SEQ))).to(dev)
    batch = {"tokens": tok, "labels": torch.roll(tok, -1, 1)}
    opt = AdamW(AdamWConfig(lr=1e-3))
    with shd.use_mesh(mesh, rules):
        params = place_params(model, mesh, rules)
        with shd.replicating():
            loss = model.loss(batch)
            grads = dict(zip(params, torch.autograd.grad(
                loss, list(params.values()))))
            grads = _constrain_like_params(grads, params)
        new, state, m = make_train_step(model, opt)(
            params, opt.init(params), batch)
    return {
        "grads_placed_as_params": all(
            grads[k].placements == params[k].placements for k in params),
        "new_placed_as_params": all(
            new[k].placements == params[k].placements for k in params),
        "m_placed_as_params": all(
            state["m"][k].placements == params[k].placements
            for k in params),
        "sharded_leaves": sum(any(getattr(p, "dim", None) is not None
                                  for p in params[k].placements)
                              for k in params),
        "n_params": len(params),
        "loss": float(m["loss"])}


def psum_inputs(rank: int) -> tuple[dict, dict]:
    """The per-rank gradients and error states of the one-step check."""
    rng = np.random.default_rng(100 + rank)
    g = {"a": rng.normal(size=(37,)).astype(np.float32),
         "b": rng.normal(size=(4, 9)).astype(np.float32)}
    e = {k: (0.1 * rng.normal(size=v.shape)).astype(np.float32)
         for k, v in g.items()}
    return g, e


def check_compressed_psum(out: Path, dev) -> dict:
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.optim.compression import compressed_psum, init_error

    rank, world = dist.get_rank(), dist.get_world_size()
    mesh = init_device_mesh(dev.type, (world,), mesh_dim_names=("data",))
    group = mesh.get_group("data")
    g, e = psum_inputs(rank)
    synced, err = compressed_psum(
        {k: torch.from_numpy(v).to(dev) for k, v in g.items()},
        {k: torch.from_numpy(v).to(dev) for k, v in e.items()}, group)
    np.savez(out / f"psum_rank{rank}.npz",
             **{f"synced_{k}": v.cpu().numpy() for k, v in synced.items()},
             **{f"err_{k}": v.cpu().numpy() for k, v in err.items()})

    # the toy regression of the JAX package's test: 64 rows a step split
    # over the ranks, w replicated
    w_true = torch.from_numpy(np.linspace(-1, 1, 16).astype(np.float32)
                              ).to(dev)
    rng = np.random.default_rng(0)
    w = torch.zeros(16, device=dev)
    err_t = init_error({"w": w})
    per = 64 // world
    for _ in range(150):
        x = torch.from_numpy(rng.normal(size=(64, 16)).astype(np.float32)
                             ).to(dev)
        y = x @ w_true
        xs, ys = x[rank * per:(rank + 1) * per], y[rank * per:(rank + 1)
                                                    * per]
        wr = w.clone().requires_grad_(True)
        (g_w,) = torch.autograd.grad(torch.mean((xs @ wr - ys) ** 2), [wr])
        g_sync, err_t = compressed_psum({"w": g_w}, err_t, group)
        w = w - 0.05 * g_sync["w"]
    return {"toy_final_mse": float(torch.mean((w - w_true) ** 2))}


def check_restore_onto(mesh, out: Path, dev) -> dict:
    import torch
    from torch.distributed.tensor import Replicate, Shard

    from repro_torch.runtime import TrainLoop, TrainLoopConfig

    res = {}
    plain_dir = out / "ckpt_plain"
    jax_dir = out / "jax_ckpt"
    for name, d in (("port", plain_dir), ("jax", jax_dir)):
        if not d.exists():
            continue
        loop = TrainLoop(None, TrainLoopConfig(), str(d),
                         batch_fn=lambda s: None)
        like = loop.ckpt.restore(None, _like_tree(d, dev))[0]
        pl = {k: ([Shard(0), Replicate()] if v.shape[0] % 2 == 0
                  else [Replicate(), Replicate()]) for k, v in like.items()}
        placed, step = loop.restore_onto(like, pl, mesh)
        res[name] = {
            "leaves": len(placed),
            "equal": all(torch.equal(placed[k].full_tensor(), like[k])
                         for k in like),
            "placed_as_asked": all(list(placed[k].placements) == pl[k]
                                   for k in like)}
    return res


def _like_tree(d: Path, dev) -> dict:
    """A like tree (float32 zeros of each leaf's shape on ``dev``) for
    the flat checkpoint under ``d``: its manifest names the leaves."""
    import torch

    step = max(int(p.name.split("_")[1]) for p in d.glob("step_*")
               if not p.name.endswith(".tmp"))
    man = json.loads((d / f"step_{step}" / "manifest.json").read_text())
    return {k: torch.zeros(v["shape"], device=dev)
            for k, v in man["leaves"].items()}


def check_full_size_steps(mesh, dev, arch: str = "gemma3-1b",
                          cut: dict | None = None, seq: int = 1024,
                          bf16_states: bool = False, steps: int = 3
                          ) -> dict:
    """``arch`` at full width in bf16 (its config changed by ``cut``),
    B 4 and T ``seq`` (gemma3-1b: phase 13's shape), remat: ``steps``
    AdamW steps sharded on ``mesh``, then (rank 0) the same steps
    unsharded on its card: losses, wall s a step (host clock to a
    synchronize) and the sharded run's peak memory on this rank."""
    import time

    import torch
    import torch.distributed as dist

    from repro_torch.configs import get_config
    from repro_torch.data import SyntheticTokens
    from repro_torch.distributed import sharding as shd
    from repro_torch.distributed.specs import place_params
    from repro_torch.launch.train import make_train_step
    from repro_torch.models.transformer import Model
    from repro_torch.optim import AdamW, AdamWConfig

    import dataclasses

    cfg = dataclasses.replace(get_config(arch), **(cut or {}))
    src = SyntheticTokens(vocab_size=cfg.vocab_size, seq_len=seq,
                          batch_size=4, seed=0)
    batches = [{k: torch.from_numpy(v).to(dev) for k, v in
                src.batch(i).items()} for i in range(steps)]
    rules = shd.use_rules()

    def run(placed: bool):
        model = Model(cfg, torch.bfloat16, loss_chunk=256, attn_chunk=512,
                      device=dev, seed=0)
        opt = AdamW(AdamWConfig(lr=1e-3, state_dtype=(
            torch.bfloat16 if bf16_states else torch.float32)))
        step = make_train_step(model, opt)
        ctx = (shd.use_mesh(mesh, rules) if placed
               else contextlib.nullcontext())
        losses, walls = [], []
        with ctx:
            p = (place_params(model, mesh, rules) if placed
                 else dict(model.named_parameters()))
            state = (p, opt.init(p))
            for b in batches:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                p, s, m = step(*state, b)
                losses.append(float(m["loss"]))
                torch.cuda.synchronize()
                walls.append(time.perf_counter() - t0)
                state = (p, s)
        return losses, walls

    torch.cuda.reset_peak_memory_stats()
    got, walls = run(True)
    out = {"losses_sharded": got, "step_s_sharded": walls,
           "peak_bytes_rank": torch.cuda.max_memory_allocated(),
           "mesh": list(mesh.shape)}
    torch.cuda.empty_cache()
    if dist.get_rank() == 0:
        want, walls_u = run(False)
        out.update(losses_plain=want, step_s_plain=walls_u)
    dist.barrier()
    return out


def worker(rank: int, world: int, out: str, cuda: bool = False) -> None:
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    torch.set_num_threads(1)
    out = Path(out)
    dev = torch.device(f"cuda:{rank}" if cuda else "cpu")
    if cuda:
        torch.cuda.set_device(dev)
    store = dist.FileStore(str(out / "store"), world)
    dist.init_process_group("nccl" if cuda else "gloo", store=store,
                            rank=rank, world_size=world)
    try:
        mesh = init_device_mesh(dev.type, (2, world // 2),
                                mesh_dim_names=("data", "model"))
        results = {"seqpar": check_seqpar_train(mesh, out, dev)}
        results["headstp"] = check_headstp_train(mesh, dev)
        results["serve"] = check_sharded_serve(mesh, dev)
        results["loop"] = check_trainloop_recovery(mesh, out, dev)
        results["moe"] = check_grad_placements(mesh, dev)
        results["grads"] = {arch: check_grad_placements(mesh, dev, arch)
                            for arch in ("jamba-1.5-large-398b",
                                         "rwkv6-7b")}
        results["families"] = check_sharded_families(mesh, dev)
        results["psum"] = check_compressed_psum(out, dev)
        dist.barrier()
        results["restore"] = check_restore_onto(mesh, out, dev)
        if cuda:
            results["full_size"] = check_full_size_steps(mesh, dev)
            results["full_size_moe"] = check_full_size_steps(
                mesh, dev, "mixtral-8x22b", {"n_layers": 1}, seq=256,
                bf16_states=True)
        if rank == 0:
            (out / "results.json").write_text(json.dumps(results))
    finally:
        dist.destroy_process_group()


def main() -> None:
    import torch.multiprocessing as mp

    out = Path(sys.argv[1])
    world = int(sys.argv[2]) if len(sys.argv) > 2 else 8
    cuda = len(sys.argv) > 3 and sys.argv[3] == "cuda"
    out.mkdir(parents=True, exist_ok=True)
    mp.start_processes(worker, args=(world, str(out), cuda), nprocs=world,
                       start_method="spawn")


if __name__ == "__main__":
    os.environ.setdefault("OMP_NUM_THREADS", "1")
    main()
