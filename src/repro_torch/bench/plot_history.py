"""Render the per-commit benchmark trajectory to SVG.

``python -m repro_torch.bench.run --json=PATH --history`` archives one
immutable ``bench_history/<sha>.json`` per commit; this module turns
that directory into a small-multiples SVG: one sparkline panel per
benchmark row, ``us_per_call`` panels in one section, the structural
``bytes_ratio`` panels in another, and (when ``loadgen/*`` rows are
present) throughput-vs-latency sections for the open-loop load harness:
sustainable and achieved requests per second, SLO attainment, and
coordinated-omission-correct end-to-end p99.  The renderer is the JAX
package's ``benchmarks/plot_history.py``, byte for byte in its output.

Commits are ordered by ``git rev-list --first-parent`` where the
checkout is available (history files are named by short sha), falling
back to file mtime.  Analytic-only rows (``analytic: true``, no timing
field) appear only in the ratio section: a 0.0 never plots.

Standard library only::

    python -m repro_torch.bench.plot_history [--history bench_history]
                                             [--out bench_history/history.svg]
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from html import escape

# Single-series panels: one accent per metric section (categorical
# slots of the validated default palette), neutral ink for text.
_C_TIME = "#2a78d6"
_C_RATIO = "#eb6834"
_C_RPS = "#13866f"
_C_SLO = "#7856c1"
_INK = "#0b0b0b"
_INK_MUTED = "#52514e"
_GRID = "#e4e3e0"
_SURFACE = "#fcfcfb"

_PANEL_W, _PANEL_H = 240, 96
_PLOT_H = 44
_COLS = 3
_PAD = 16


def load_history(history_dir: str) -> list[tuple[str, dict]]:
    """[(sha, rows)] ordered oldest -> newest."""
    shas = [f[:-5] for f in os.listdir(history_dir)
            if f.endswith(".json")]
    if not shas:
        return []
    order = {}
    try:
        log = subprocess.run(
            ["git", "rev-list", "--first-parent", "--reverse", "HEAD"],
            capture_output=True, text=True, timeout=30).stdout.split()
        for i, full in enumerate(log):
            for s in shas:
                if full.startswith(s):
                    order[s] = i
    except (OSError, subprocess.SubprocessError):
        pass

    def key(s: str):
        if s in order:
            return (0, order[s])
        return (1, os.path.getmtime(os.path.join(history_dir,
                                                 f"{s}.json")))

    out = []
    for s in sorted(shas, key=key):
        try:
            with open(os.path.join(history_dir, f"{s}.json")) as fh:
                out.append((s, json.load(fh)))
        except (OSError, json.JSONDecodeError):
            continue
    return out


def _series(history, metric: str) -> dict[str, list]:
    """row name -> per-commit values (None where absent)."""
    names = sorted({n for _, rows in history for n in rows
                    if isinstance(rows[n].get(metric), (int, float))})
    return {n: [rows.get(n, {}).get(metric) for _, rows in history]
            for n in names}


def _fmt(v: float) -> str:
    if v >= 1e6:
        return f"{v / 1e6:.1f}M"
    if v >= 1e4:
        return f"{v / 1e3:.0f}k"
    if v >= 100:
        return f"{v:.0f}"
    return f"{v:.2f}".rstrip("0").rstrip(".")


def _panel(x0: float, y0: float, name: str, vals: list, color: str,
           unit: str) -> list[str]:
    """One sparkline panel at (x0, y0); gaps where a commit lacks the
    row."""
    pts = [(i, v) for i, v in enumerate(vals) if v is not None]
    lo = min(v for _, v in pts)
    hi = max(v for _, v in pts)
    span = (hi - lo) or max(abs(hi), 1e-9)
    px0, px1 = x0 + 4, x0 + _PANEL_W - 44
    py0, py1 = y0 + 22, y0 + 22 + _PLOT_H
    nx = max(len(vals) - 1, 1)

    def xy(i, v):
        return (px0 + (px1 - px0) * i / nx,
                py1 - (py1 - py0) * (v - lo) / span)

    title = name[len("kernels/"):] if name.startswith("kernels/") else name
    out = [f'<text x="{x0 + 4}" y="{y0 + 13}" class="t">'
           f'{escape(title)}</text>',
           f'<line x1="{px0}" y1="{py1}" x2="{px1}" y2="{py1}" '
           f'class="g"/>']
    # polyline segments between consecutive commits that both have data
    seg: list[str] = []
    prev_i = None
    for i, v in pts:
        if prev_i is not None and i == prev_i + 1:
            seg.append("{:.1f},{:.1f}".format(*xy(i, v)))
        else:
            if len(seg) > 1:
                out.append(f'<polyline points="{" ".join(seg)}" '
                           f'class="s" stroke="{color}"/>')
            seg = ["{:.1f},{:.1f}".format(*xy(i, v))]
        prev_i = i
    if len(seg) > 1:
        out.append(f'<polyline points="{" ".join(seg)}" class="s" '
                   f'stroke="{color}"/>')
    lx, ly = xy(*pts[-1])
    out.append(f'<circle cx="{lx:.1f}" cy="{ly:.1f}" r="2.5" '
               f'fill="{color}"/>')
    out.append(f'<text x="{px1 + 6}" y="{ly + 4:.1f}" class="v">'
               f'{_fmt(pts[-1][1])}{unit}</text>')
    if hi > lo:
        out.append(f'<text x="{px0}" y="{py1 + 12}" class="m">'
                   f'{_fmt(lo)}–{_fmt(hi)}{unit}</text>')
    return out


def _section(parts: list[str], series: dict[str, list], y: float,
             heading: str, color: str, unit: str) -> float:
    if not series:
        return y
    parts.append(f'<text x="{_PAD}" y="{y + 14}" class="h">'
                 f'{escape(heading)}</text>')
    y += 24
    for k, (name, vals) in enumerate(series.items()):
        x0 = _PAD + (k % _COLS) * (_PANEL_W + _PAD)
        y0 = y + (k // _COLS) * (_PANEL_H + 4)
        parts.extend(_panel(x0, y0, name, vals, color, unit))
    rows = (len(series) + _COLS - 1) // _COLS
    return y + rows * (_PANEL_H + 4) + 12


def render_svg(history: list[tuple[str, dict]]) -> str:
    times = _series(history, "us_per_call")
    ratios = _series(history, "bytes_ratio")
    # loadgen throughput-vs-latency: achieved + bisected-sustainable
    # rates in one section, SLO attainment and open-loop e2e p99 in
    # their own (only loadgen rows carry these metrics)
    rps = _series(history, "achieved_rps")
    rps.update({f"{n} (max sustainable)": vals for n, vals in
                _series(history, "sustainable_rps").items()})
    slo = _series(history, "slo_attainment")
    e2e = {n: vals for n, vals in
           _series(history, "e2e_ms_p99").items()
           if n.startswith("loadgen/")}
    width = _PAD + _COLS * (_PANEL_W + _PAD)
    parts: list[str] = []
    y = float(_PAD)
    parts.append(f'<text x="{_PAD}" y="{y + 14}" class="hh">Benchmark '
                 f'trajectory — {len(history)} commits '
                 f'({escape(history[0][0])} → {escape(history[-1][0])})'
                 f'</text>')
    y += 28
    y = _section(parts, times, y, "us_per_call (wall clock per call)",
                 _C_TIME, "")
    y = _section(parts, ratios, y,
                 "bytes_ratio (structural, sequential ÷ fused path)",
                 _C_RATIO, "×")
    y = _section(parts, rps, y,
                 "load harness throughput (requests/s, open-loop)",
                 _C_RPS, "")
    y = _section(parts, slo, y,
                 "SLO attainment (fraction of offered requests)",
                 _C_SLO, "")
    y = _section(parts, e2e, y,
                 "open-loop e2e p99 (ms from intended arrival)",
                 _C_SLO, "ms")
    height = int(y) + _PAD
    head = (
        f'<svg xmlns="http://www.w3.org/2000/svg" width="{width}" '
        f'height="{height}" viewBox="0 0 {width} {height}" '
        f'font-family="system-ui, sans-serif">'
        f'<style>'
        f'.hh{{font-size:13px;font-weight:600;fill:{_INK}}}'
        f'.h{{font-size:12px;font-weight:600;fill:{_INK}}}'
        f'.t{{font-size:10px;fill:{_INK_MUTED}}}'
        f'.v{{font-size:10px;fill:{_INK}}}'
        f'.m{{font-size:9px;fill:{_INK_MUTED}}}'
        f'.s{{fill:none;stroke-width:2;stroke-linejoin:round}}'
        f'.g{{stroke:{_GRID};stroke-width:1}}'
        f'</style>'
        f'<rect width="{width}" height="{height}" fill="{_SURFACE}"/>')
    return head + "".join(parts) + "</svg>"


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--history", default="bench_history",
                    help="directory of per-commit <sha>.json artifacts")
    ap.add_argument("--out", default=None,
                    help="output SVG path (default: "
                         "<history>/history.svg)")
    args = ap.parse_args(argv)
    out = args.out or os.path.join(args.history, "history.svg")
    if not os.path.isdir(args.history):
        print(f"# no history directory at {args.history}; nothing to "
              f"plot")
        return 0
    history = load_history(args.history)
    if not history:
        print(f"# no history artifacts in {args.history}; nothing to "
              f"plot")
        return 0
    svg = render_svg(history)
    with open(out, "w") as fh:
        fh.write(svg)
    n_rows = len({n for _, rows in history for n in rows})
    print(f"# wrote {out}: {len(history)} commits x {n_rows} rows")
    return 0


if __name__ == "__main__":
    sys.exit(main())
