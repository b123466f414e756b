"""Multi-pod dry run: trace every (arch x shape x mesh) cell, sharded.

The port of the JAX package's ``launch/dryrun.py``.  For each cell:
  1. starts a fake process group of ``chips`` ranks in this process
     (``launch.mesh.fake_world``) and builds the production mesh
     (32 x 8 single pod / 2 x 32 x 8 multi-pod, H100 hosts of 8),
  2. picks the sharding rules for the arch (heads-TP, or sequence-
     parallel where the head count does not divide the model axis;
     batch rules degrade when B < shards),
  3. builds the model on the ``meta`` device (nothing allocated), places
     its params (and the AdamW state, the batch, the decode cache) as
     DTensors by the logical spec trees, and runs one train, prefill or
     decode step as rank 0 under ``launch.op_cost.OpCost``: every local
     op and collective counted, every live byte of the rank's shards
     tracked,
  4. records the traced per-device peak, the analytic ``est_peak``,
     ``fits_80GB``, the three-term roofline (``launch/roofline.py``),
     the model FLOPs and the useful share, and appends the cell to the
     results JSON (``--out``).

Where the JAX package lowers and compiles an XLA program, the port runs
its eager program on stand-ins: its counts are those of the code the
card would run (unfused; attention through ``chunked_attention``, the
flash kernel being a card-only launch; MoE experts, Mamba channels and
RWKV6 heads on each rank's ``model`` slice, as the JAX package places
them: ``sharding.TensorParallel``).

Usage:
  python -m repro_torch.launch.dryrun --arch gemma3-1b --shape train_4k
  python -m repro_torch.launch.dryrun --all [--mesh both|pod|multipod]
  python -m repro_torch.launch.dryrun --all --out build/dryrun.json
"""

from __future__ import annotations

import argparse
import json
import time
import traceback
from pathlib import Path

import torch

from repro_torch.configs import SHAPES, applicable_shapes, get_config
from repro_torch.configs.shapes import LONG_SKIP_REASONS, ShapeSpec
from repro_torch.distributed import sharding as shd
from repro_torch.distributed.specs import place_cache, place_params, place_tree
from repro_torch.launch import inputs as inp
from repro_torch.launch.mesh import (fake_world, make_production_mesh,
                                     mesh_name, production_shape)
from repro_torch.launch.op_cost import OpCost
from repro_torch.launch.roofline import (HBM_BYTES, analyze, estimate_peak,
                                         model_flops)
from repro_torch.launch.serve import make_prefill_step, make_serve_step
from repro_torch.launch.train import make_train_step
from repro_torch.models.transformer import Model
from repro_torch.optim.adamw import AdamW, AdamWConfig

ARCHS = [
    "whisper-small", "mixtral-8x22b", "grok-1-314b", "rwkv6-7b",
    "starcoder2-3b", "command-r-35b", "gemma3-1b", "llama3-405b",
    "jamba-1.5-large-398b", "internvl2-26b",
]

# Microbatch accumulation for the train shape (keeps activations in HBM).
ACCUM = {
    "llama3-405b": 8, "jamba-1.5-large-398b": 8, "grok-1-314b": 4,
    "command-r-35b": 4, "mixtral-8x22b": 4, "internvl2-26b": 4,
    "rwkv6-7b": 2, "starcoder2-3b": 1, "gemma3-1b": 1,
    "whisper-small": 1,
}

# >=100B-class archs train with bf16 states + stochastic rounding
# (8 bytes/param total; see repro_torch.optim.adamw).
BF16_STATE = {"llama3-405b", "jamba-1.5-large-398b", "grok-1-314b",
              "mixtral-8x22b"}

# hillclimb variants: model-construction overrides, selected with
# --variant; results are keyed "<cell>#<variant>" so baselines persist.
VARIANTS: dict[str, dict] = {
    "rwkv-chunk32": {"rwkv_chunk": 32},
    "rwkv-chunk64": {"rwkv_chunk": 64},
    "rwkv-chunk128": {"rwkv_chunk": 128},
}

# train-step accumulation overrides per variant
VARIANT_ACCUM: dict[str, int] = {
    "accum16": 16,
    "accum32": 32,
}
for _v in VARIANT_ACCUM:
    VARIANTS.setdefault(_v, {})


def seqpar(cfg, mesh) -> bool:
    """Sequence-parallel attention: the head count does not divide the
    model axis (the reason the JAX package's ``SEQPAR`` set states; at
    model 16 this gives that set, at the H100 mesh's model 8 gemma3-1b
    and whisper-small)."""
    return cfg.n_heads % shd.axis_sizes(mesh).get("model", 1) != 0


def rules_for(arch: str, shape: ShapeSpec, mesh, cfg=None) -> dict:
    cfg = get_config(arch) if cfg is None else cfg
    sizes = shd.axis_sizes(mesh)
    overrides = {}
    if seqpar(cfg, mesh):
        overrides.update(shd.SEQPAR_RULES_OVERRIDES)
    n_batch_shards = sizes.get("pod", 1) * sizes.get("data", 1)
    if shape.global_batch % n_batch_shards != 0:
        overrides["batch"] = ("data",) if shape.global_batch % \
            sizes.get("data", 1) == 0 else None
    return shd.use_rules(**overrides)


def build_model(arch: str, variant: str | None = None, cfg=None) -> Model:
    """The arch's model in bf16 with remat, on the ``meta`` device."""
    cfg = get_config(arch) if cfg is None else cfg
    kw = dict(VARIANTS.get(variant, {}))
    return Model(cfg, torch.bfloat16, remat=True, device="meta", seed=None,
                 **kw)


def make_optimizer(arch: str) -> AdamW:
    if arch in BF16_STATE:
        return AdamW(AdamWConfig(state_dtype=torch.bfloat16,
                                 stochastic_rounding=True))
    return AdamW(AdamWConfig(state_dtype=torch.float32))


def trace_cell(arch: str, shape: ShapeSpec, mesh, *,
               variant: str | None = None, cfg=None) -> tuple:
    """Run the cell's step once as this rank of ``mesh`` under
    ``OpCost``.  Returns (cost, model, rules, accum, arg bytes, wall s)."""
    model = build_model(arch, variant, cfg)
    cfg = model.cfg
    rules = rules_for(arch, shape, mesh, cfg)
    accum = VARIANT_ACCUM.get(variant or "", ACCUM.get(arch, 1))
    cost = OpCost(mesh)
    t0 = time.perf_counter()
    with shd.use_mesh(mesh, rules):
        params = place_params(model, mesh, rules)
        if shape.kind == "decode":
            cache = place_cache(model.init_cache(shape.global_batch,
                                                 shape.seq_len), mesh, rules)
            tok, tok_log = inp.decode_token_specs(cfg, shape)
            tok = place_tree(mesh, rules, tok, tok_log)
            arg_bytes = cost.track(params, cache, tok)
            with cost:
                make_serve_step(model)(params, tok, cache, shape.seq_len - 1)
        else:
            batch = place_tree(mesh, rules, inp.input_specs(cfg, shape),
                               inp.input_logical(cfg, shape))
            if shape.kind == "train":
                opt = make_optimizer(arch)
                opt_state = opt.init(params)
                arg_bytes = cost.track(params, opt_state, batch)
                gen = torch.Generator().manual_seed(inp.rng_spec())
                with cost:
                    make_train_step(model, opt, accum_steps=accum)(
                        params, opt_state, batch, gen)
            else:
                # a vision prefix rides in the cache before the prompt
                prefix = cfg.frontend_len if cfg.frontend == "vision" else 0
                arg_bytes = cost.track(params, batch)
                with cost:
                    make_prefill_step(model, max_len=shape.seq_len + prefix)(
                        params, batch)
    return cost, model, rules, accum, arg_bytes, time.perf_counter() - t0


def cell_result(arch: str, shape: ShapeSpec, mesh, mesh_label: str, *,
                variant: str | None = None, cfg=None) -> dict:
    """The cell's result on ``mesh`` (a mesh of a running process group;
    see :func:`lower_cell` for the production one)."""
    cost, model, rules, accum, arg_bytes, wall = trace_cell(
        arch, shape, mesh, variant=variant, cfg=cfg)
    cfg = model.cfg
    chips = mesh.size()
    rl = analyze(cost, chips)
    mf = model_flops(cfg, shape)
    est_peak = estimate_peak(
        cfg, shape, chips, shd.axis_sizes(mesh).get("model", 1),
        accum if shape.kind == "train" else 1, arg_bytes)
    return {
        "arch": arch, "shape": shape.name, "mesh": mesh_label,
        "chips": chips, "status": "ok",
        "rules": "seqpar" if seqpar(cfg, mesh) else "heads-tp",
        "trace_s": round(wall, 1),
        "arg_bytes": arg_bytes,
        "peak_bytes_per_device": cost.peak,
        "est_peak_bytes": est_peak,
        "fits_80GB_traced": bool(cost.peak < HBM_BYTES),
        "fits_80GB": bool(est_peak < HBM_BYTES),
        "roofline": rl.summary(),
        "model_flops_total": mf,
        "model_flops_per_chip": mf / chips,
        "useful_flops_frac": (mf / chips) / max(rl.flops, 1.0),
        "collectives": len(cost.records),
    }


def lower_cell(arch: str, shape: ShapeSpec, multi_pod: bool = False, *,
               variant: str | None = None, mesh=None, cfg=None) -> dict:
    """One cell: on the production mesh of a fake group started here, or
    on ``mesh`` (its group already running, e.g. a test's (2, 4))."""
    if mesh is not None:
        label = "x".join(str(n) for n in tuple(mesh.shape))
        return cell_result(arch, shape, mesh, label, variant=variant,
                           cfg=cfg)
    dims, _ = production_shape(multi_pod)
    chips = 1
    for n in dims:
        chips *= n
    with fake_world(chips):
        return cell_result(arch, shape,
                           make_production_mesh(multi_pod=multi_pod),
                           mesh_name(multi_pod), variant=variant, cfg=cfg)


def load_results(path: Path) -> dict:
    if path.exists():
        return json.loads(path.read_text())
    return {}


def save_results(path: Path, results: dict) -> None:
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(results, indent=1, sort_keys=True))


def cell_key(arch, shape_name, multi_pod):
    return f"{arch}|{shape_name}|{mesh_name(multi_pod)}"


def skip_records(archs, shape_name: str | None, meshes) -> dict:
    """The recorded skips (``LONG_SKIP_REASONS``) of a run over
    ``archs`` (every shape, or ``shape_name``) on ``meshes``."""
    out = {}
    for arch in archs:
        if arch in LONG_SKIP_REASONS and shape_name in (None, "long_500k"):
            for mp in meshes:
                out[cell_key(arch, "long_500k", mp)] = {
                    "arch": arch, "shape": "long_500k",
                    "mesh": mesh_name(mp), "status": "skipped",
                    "reason": LONG_SKIP_REASONS[arch],
                }
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--mesh", default="both",
                    choices=["pod", "multipod", "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--variant", default=None, choices=sorted(VARIANTS))
    ap.add_argument("--out", default="build/dryrun_results.json")
    args = ap.parse_args(argv)

    out = Path(args.out)
    results = load_results(out)

    cells = []
    archs = ARCHS if (args.all or not args.arch) else [args.arch]
    meshes = {"pod": [False], "multipod": [True],
              "both": [False, True]}[args.mesh]
    for arch in archs:
        cfg = get_config(arch)
        shapes = ([SHAPES[args.shape]] if args.shape
                  else applicable_shapes(cfg))
        for s in shapes:
            for mp in meshes:
                cells.append((arch, s, mp))
    results.update(skip_records(archs, args.shape, meshes))

    for arch, s, mp in cells:
        key = cell_key(arch, s.name, mp)
        if args.variant:
            key = f"{key}#{args.variant}"
        if not args.force and results.get(key, {}).get("status") == "ok":
            print(f"[skip cached] {key}", flush=True)
            continue
        print(f"[cell] {key} ...", flush=True)
        try:
            res = lower_cell(arch, s, mp, variant=args.variant)
            print(f"  -> {res['status']} trace={res['trace_s']}s "
                  f"peak={res['peak_bytes_per_device']/1e9:.2f}GB "
                  f"est_peak={res['est_peak_bytes']/1e9:.2f}GB "
                  f"fits_80GB={res['fits_80GB']} "
                  f"dominant={res['roofline']['dominant']}", flush=True)
        except Exception as e:  # noqa: BLE001 - a cell's failure is recorded
            res = {"arch": arch, "shape": s.name, "mesh": mesh_name(mp),
                   "status": "error", "error": str(e)[:2000],
                   "trace": traceback.format_exc()[-4000:]}
            print(f"  -> ERROR {str(e)[:300]}", flush=True)
        results[key] = res
        save_results(out, results)

    n_ok = sum(1 for r in results.values() if r.get("status") == "ok")
    print(f"done: {n_ok} ok / {len(results)} recorded")


if __name__ == "__main__":
    main()
