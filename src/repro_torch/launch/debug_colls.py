"""Debug tool: the top collectives of a cell's traced step.

    python -m repro_torch.launch.debug_colls --arch gemma3-1b --shape train_4k
    python -m repro_torch.launch.debug_colls --arch llama3-405b \\
        --shape decode_32k --multipod --top 20

The port of the JAX package's ``launch/debug_colls.py``.  Where that one
parses the compiled HLO and multiplies each collective by its loop's
trip count, this one traces the cell's step once as the dry run does
(``launch.dryrun.trace_cell``, rank 0 of a fake group on the production
mesh) and reads ``launch.op_cost``'s record of every collective DTensor
issued as it ran: its kind, output bytes, the mesh axis of its group and
the port's code that issued it.  Collectives of one (kind, axis, bytes,
source) are summed; the largest totals are printed.  ``--reduced``
traces the arch's reduced config (a quick look; the shape is the
cell's).
"""

from __future__ import annotations

import argparse
from collections import defaultdict

from repro_torch.configs import SHAPES, get_config, reduced


def top_collectives(records: list[dict], top: int) -> list[tuple]:
    """(total bytes, bytes each, count, kind, axis, source) of the
    ``top`` largest groups of ``records``."""
    groups: dict = defaultdict(int)
    for r in records:
        groups[(r["bytes"], r["kind"], r["axis"], r["source"])] += 1
    rows = [(b * n, b, n, kind, axis, src)
            for (b, kind, axis, src), n in groups.items()]
    rows.sort(reverse=True)
    return rows[:top]


def main(argv=None) -> list[tuple]:
    from repro_torch.launch import dryrun as dr
    from repro_torch.launch.mesh import (fake_world, make_production_mesh,
                                         production_shape)

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True, choices=sorted(SHAPES))
    ap.add_argument("--multipod", action="store_true")
    ap.add_argument("--top", type=int, default=15)
    ap.add_argument("--reduced", action="store_true")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced(cfg)
    dims, _ = production_shape(args.multipod)
    chips = 1
    for n in dims:
        chips *= n
    with fake_world(chips):
        mesh = make_production_mesh(multi_pod=args.multipod)
        cost = dr.trace_cell(args.arch, SHAPES[args.shape], mesh, cfg=cfg)[0]
    rows = top_collectives(cost.records, args.top)
    print(f"{cfg.name} {args.shape} on {'x'.join(map(str, dims))}: "
          f"{len(cost.records)} collectives, "
          f"{sum(r['bytes'] for r in cost.records) / 1e9:.3f} GB")
    print("\nTop collectives (total bytes = bytes each x count):")
    for tot, b, n, kind, axis, src in rows:
        print(f"  {tot / 1e9:8.3f} GB  ({b / 1e6:8.2f} MB x {n:4d})  "
              f"{kind:<15s} {axis:<6s} {src}")
    return rows


if __name__ == "__main__":
    main()
