"""Train a ~100M-parameter LM with the full production stack.

The port's counterpart of ``examples/train_lm.py``, with its presets and
flags, plus ``--device``: the config-driven model, AdamW (optionally
bf16 states + stochastic rounding), the sharded data loader, the
fault-tolerant ``TrainLoop`` (checkpoint/restart + straggler watchdog)
and the cosine schedule.

The default preset is a 110M dense decoder (12L x 768, GQA 12/4, vocab
32k); ``--preset tiny`` runs in seconds on the CPU.

    python -m repro_torch.launch.train_lm --steps 20 --preset tiny \\
        --device cpu

Runs on ``--device`` (``cuda`` unless ``cpu`` asks for the plain
versions).  Prints the loss from the first step to the last.
"""

from __future__ import annotations

import argparse
import os
import tempfile

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.data import ShardedLoader, SyntheticTokens
from repro_torch.engine.engine import resolve_device
from repro_torch.launch.train import make_train_step
from repro_torch.models.transformer import Model
from repro_torch.optim import AdamW, AdamWConfig, cosine_schedule
from repro_torch.runtime import TrainLoop, TrainLoopConfig

PRESETS = {
    "100m": ArchConfig(
        name="lm-100m", family="dense", n_layers=12, d_model=768,
        n_heads=12, n_kv_heads=4, d_ff=3072, vocab_size=32768,
        head_dim=64, max_seq_len=2048, source="example"),
    "tiny": ArchConfig(
        name="lm-tiny", family="dense", n_layers=2, d_model=128,
        n_heads=4, n_kv_heads=2, d_ff=256, vocab_size=512,
        head_dim=32, max_seq_len=512, source="example"),
}


def main(argv=None):
    """Returns the finished ``TrainLoop``."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--preset", default="tiny", choices=sorted(PRESETS))
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_lm_ckpt"))
    ap.add_argument("--stochastic-rounding", action="store_true",
                    help="bf16 params + stochastic rounding (paper C3)")
    ap.add_argument("--device", default="cuda",
                    help="torch device (cuda needs a card; cpu runs the "
                         "plain versions)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = PRESETS[args.preset]
    print(f"{cfg.name}: {cfg.n_params()/1e6:.1f}M params")

    sr = args.stochastic_rounding
    model = Model(cfg, torch.bfloat16 if sr else torch.float32,
                  loss_chunk=min(256, args.seq),
                  attn_chunk=min(512, args.seq), device=dev, seed=0)
    opt = AdamW(AdamWConfig(
        lr=cosine_schedule(args.lr, warmup_steps=10,
                           total_steps=args.steps),
        state_dtype=torch.bfloat16 if sr else torch.float32,
        stochastic_rounding=sr))

    params = dict(model.named_parameters())
    opt_state = opt.init(params)
    step_fn = make_train_step(model, opt)

    source = SyntheticTokens(vocab_size=cfg.vocab_size, seq_len=args.seq,
                             batch_size=args.batch, seed=0)
    loader = ShardedLoader(source.batch, prefetch=2)

    def batch_fn(step):
        return {k: torch.from_numpy(v).to(dev)
                for k, v in loader.get(step).items()}

    loop = TrainLoop(
        step_fn,
        TrainLoopConfig(total_steps=args.steps,
                        checkpoint_every=max(10, args.steps // 5)),
        args.ckpt_dir, batch_fn=batch_fn)
    loop.run((params, opt_state))

    first = loop.metrics_log[0]["loss"] if loop.metrics_log else float("nan")
    last = loop.metrics_log[-1]["loss"] if loop.metrics_log else float("nan")
    print(f"loss: {first:.3f} -> {last:.3f} over "
          f"{len(loop.metrics_log)} steps "
          f"(stragglers: {len(loop.straggler_events)})")
    return loop


if __name__ == "__main__":
    main()
