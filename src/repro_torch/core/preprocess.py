"""MNIST-style preprocessing from the paper §3.1: deskew + soft threshold.

Image operations applied before encoding, in float32, with the batch
axis written out.  They agree with ``repro.core.preprocess`` to float
rounding (the sums run in another order).
"""

from __future__ import annotations

import torch


def _image_moments(img: torch.Tensor
                   ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Centroid row, centroid column and shear coefficient of each image
    float32[B, h, w], each float32[B, 1, 1]."""
    _, h, w = img.shape
    total = img.sum(dim=(1, 2), keepdim=True) + 1e-6
    ys = torch.arange(h, dtype=torch.float32, device=img.device)[:, None]
    xs = torch.arange(w, dtype=torch.float32, device=img.device)[None, :]
    cy = (ys * img).sum(dim=(1, 2), keepdim=True) / total
    cx = (xs * img).sum(dim=(1, 2), keepdim=True) / total
    mu_yy = ((ys - cy) ** 2 * img).sum(dim=(1, 2), keepdim=True) / total
    mu_xy = ((ys - cy) * (xs - cx) * img).sum(dim=(1, 2),
                                              keepdim=True) / total
    return cy, cx, mu_xy / (mu_yy + 1e-6)


def deskew(img: torch.Tensor) -> torch.Tensor:
    """Shear each image so its principal vertical axis is upright.

    Estimates the shear ``alpha`` from image moments and resamples
    ``x' = x + alpha * (y - cy)`` with linear interpolation along rows.
    img float32[h, w] or [B, h, w] in [0, 1].
    """
    if img.ndim == 2:
        return deskew(img[None])[0]
    _, h, w = img.shape
    cy, _, alpha = _image_moments(img)
    ys = torch.arange(h, dtype=torch.float32, device=img.device)[:, None]
    xs = torch.arange(w, dtype=torch.float32, device=img.device)[None, :]
    src_x = xs + alpha * (ys - cy)
    x0 = torch.floor(src_x)
    frac = src_x - x0
    x0i = x0.to(torch.int64).clamp(0, w - 1)
    x1i = (x0i + 1).clamp(0, w - 1)
    out = (torch.gather(img, 2, x0i) * (1.0 - frac)
           + torch.gather(img, 2, x1i) * frac)
    inb = (src_x >= 0) & (src_x <= w - 1)
    return torch.where(inb, out, torch.zeros_like(out))


def soft_threshold(img: torch.Tensor, thresh: float = 0.1) -> torch.Tensor:
    """Soft-threshold shrinkage: max(x - t, 0) rescaled back to [0, 1]."""
    return torch.clamp(img - thresh, min=0.0) / (1.0 - thresh)


def preprocess(img: torch.Tensor, thresh: float = 0.1) -> torch.Tensor:
    """The paper's pipeline: deskew then soft threshold.  [h, w] ->
    [h, w]."""
    return soft_threshold(deskew(img), thresh)


def preprocess_batch(imgs: torch.Tensor, thresh: float = 0.1
                     ) -> torch.Tensor:
    """:func:`preprocess` over a batch float32[B, h, w]."""
    return soft_threshold(deskew(torch.as_tensor(imgs, dtype=torch.float32)),
                          thresh)
