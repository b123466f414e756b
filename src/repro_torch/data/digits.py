"""Procedural 28x28 digit dataset — offline substitute for MNIST.

The paper's MNIST experiments run offline on a procedurally rendered
digit set with the same format (28x28 grayscale in [0, 255] ->
normalized, labels 0-9).  Each class is drawn from its own
hand-designed stroke path (curved polylines approximating handwritten
digit shapes, NOT a shared seven-segment grid — shared
segments would make classes nested subsets, which no count-based
classifier can separate), anti-aliased, with per-sample random affine
jitter (translation, rotation, shear, scale), stroke-width variation and
pixel noise.

A copy of ``repro.data.digits`` (numpy only), so both packages render
identical samples from one seed.
"""

from __future__ import annotations

import numpy as np

_H = _W = 28

# Per-class stroke paths: list of polylines, points in a unit box,
# y grows downward.  Curves are approximated by short chords.


def _ellipse(cx, cy, rx, ry, n=14, t0=0.0, t1=2 * np.pi):
    ts = np.linspace(t0, t1, n)
    return [(cx + rx * np.sin(t), cy - ry * np.cos(t)) for t in ts]


_DIGIT_PATHS: dict[int, list[list[tuple[float, float]]]] = {
    0: [_ellipse(0.50, 0.50, 0.26, 0.34)],
    1: [[(0.34, 0.28), (0.54, 0.12), (0.54, 0.88)]],
    2: [[(0.27, 0.32), (0.33, 0.16), (0.55, 0.11), (0.72, 0.22),
         (0.72, 0.38), (0.50, 0.58), (0.28, 0.78), (0.26, 0.87),
         (0.76, 0.87)]],
    3: [[(0.28, 0.20), (0.48, 0.11), (0.68, 0.21), (0.66, 0.38),
         (0.48, 0.47), (0.68, 0.56), (0.72, 0.74), (0.52, 0.88),
         (0.28, 0.80)]],
    4: [[(0.62, 0.12), (0.24, 0.62), (0.80, 0.62)],
        [(0.62, 0.12), (0.62, 0.88)]],
    5: [[(0.72, 0.12), (0.32, 0.12), (0.29, 0.45), (0.55, 0.40),
         (0.73, 0.55), (0.70, 0.76), (0.50, 0.88), (0.28, 0.80)]],
    6: [[(0.64, 0.12), (0.44, 0.26), (0.32, 0.50), (0.32, 0.72),
         (0.48, 0.87), (0.66, 0.78), (0.68, 0.60), (0.52, 0.50),
         (0.34, 0.58)]],
    7: [[(0.24, 0.13), (0.76, 0.13), (0.46, 0.88)]],
    8: [_ellipse(0.50, 0.29, 0.20, 0.17),
        _ellipse(0.50, 0.68, 0.24, 0.21)],
    9: [_ellipse(0.52, 0.30, 0.19, 0.18),
        [(0.71, 0.30), (0.69, 0.55), (0.62, 0.88)]],
}


def _render(digit: int, rng: np.random.Generator) -> np.ndarray:
    """Render one jittered digit as float32[28, 28] in [0, 1]."""
    scale = rng.uniform(0.78, 1.02)
    theta = rng.uniform(-0.16, 0.16)
    shear = rng.uniform(-0.14, 0.14)
    tx, ty = rng.uniform(-1.8, 1.8, size=2)
    width = rng.uniform(0.9, 1.6)

    c, s = np.cos(theta), np.sin(theta)
    A = np.array([[c, -s], [s, c]]) @ np.array([[1.0, shear], [0.0, 1.0]])

    ys, xs = np.mgrid[0:_H, 0:_W].astype(np.float32)
    img = np.zeros((_H, _W), np.float32)
    for path in _DIGIT_PATHS[digit]:
        pts = [A @ (np.array([px - 0.5, py - 0.5]) * scale * 22.0)
               + (14 + tx, 14 + ty) for px, py in path]
        for p0, p1 in zip(pts[:-1], pts[1:]):
            d = p1 - p0
            L2 = max(float(d @ d), 1e-6)
            t = ((xs - p0[0]) * d[0] + (ys - p0[1]) * d[1]) / L2
            t = np.clip(t, 0.0, 1.0)
            px_ = p0[0] + t * d[0]
            py_ = p0[1] + t * d[1]
            dist = np.sqrt((xs - px_) ** 2 + (ys - py_) ** 2)
            img = np.maximum(img, np.clip(width + 0.5 - dist, 0.0, 1.0))

    img += rng.normal(0.0, 0.04, img.shape).astype(np.float32)
    return np.clip(img, 0.0, 1.0)


def make_digits(n: int, seed: int = 0) -> tuple[np.ndarray, np.ndarray]:
    """n samples -> (images float32[n, 784] in [0,1], labels int32[n])."""
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, 10, size=n).astype(np.int32)
    imgs = np.stack([_render(int(d), rng) for d in labels])
    return imgs.reshape(n, _H * _W), labels
