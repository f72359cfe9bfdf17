"""Image resize on any device with OpenCV's arithmetic, without OpenCV.

``resize(x, (h, w), mode)`` on an [N, H, W, C] float tensor computes what
``cv2.resize`` computes on float32 input, for ``linear`` (INTER_LINEAR),
``cubic`` (INTER_CUBIC), ``nearest`` (INTER_NEAREST), ``area`` (INTER_AREA)
and ``lanczos4`` (INTER_LANCZOS4). Like OpenCV it is separable: a pass along
the width, then one along the height, each a sum over a few taps, taken in
OpenCV's order. The taps and weights of each axis come from OpenCV's own
formulas, evaluated on the host in OpenCV's precision (source positions in
double, weights in float32), and are cached per (size in, size out, mode):

* linear: half-pixel source position (dst + 0.5) * scale - 0.5, two taps,
  the position clamped to the first and last pixel;
* cubic: the same position unclamped, four taps of Keys' kernel with
  a = -0.75, the taps past either edge replicated (the border rule of
  ``F.interpolate(mode="bicubic", align_corners=False)``, too);
* nearest: floor(dst * scale), OpenCV's legacy rule (torch's "nearest", not
  "nearest-exact");
* area: on a downscale of both axes, box weights over fractional source
  cells (OpenCV's ``computeResizeAreaTab``); otherwise OpenCV's area-mode
  linear rule, which on an integer upscale is replication;
* lanczos4: eight taps of the windowed sinc with a = 4, normalised to sum
  1, the taps past either edge replicated.

OpenCV also sums each tap's product in float32 (or with FMA where its SIMD
paths use it), so a value may differ from OpenCV's by float32 rounding.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

MODES = ("linear", "cubic", "nearest", "area", "lanczos4")

_CUBIC_A = np.float32(-0.75)


def _cubic_weights(fx: np.ndarray) -> np.ndarray:
    """OpenCV's ``interpolateCubic`` in float32: [n] -> [n, 4]."""
    a = _CUBIC_A
    one = np.float32(1)
    x1 = fx + one
    c0 = ((a * x1 - np.float32(5) * a) * x1 + np.float32(8) * a) * x1 - np.float32(4) * a
    c1 = ((a + np.float32(2)) * fx - (a + np.float32(3))) * fx * fx + one
    r = one - fx
    c2 = ((a + np.float32(2)) * r - (a + np.float32(3))) * r * r + one
    c3 = one - c0 - c1 - c2
    return np.stack([c0, c1, c2, c3], axis=1).astype(np.float32)


_S45 = 0.70710678118654752440084436210485
_LANCZOS_CS = ((1, 0), (-_S45, -_S45), (0, 1), (_S45, -_S45), (-1, 0),
               (_S45, _S45), (0, -1), (-_S45, _S45))


def _lanczos4_weights(fx: np.ndarray) -> np.ndarray:
    """OpenCV's ``interpolateLanczos4``: [n] float32 -> [n, 8] float32, the
    sum accumulated and inverted in float32 as there."""
    out = np.empty((fx.shape[0], 8), np.float32)
    for n, x in enumerate(fx):
        x = np.float32(x)
        y0 = -(float(x) + 3) * math.pi * 0.25
        s0, c0 = math.sin(y0), math.cos(y0)
        total = np.float32(0)
        for i in range(8):
            y0_ = x + np.float32(3 - i)
            if abs(y0_) >= np.float32(1e-6):
                y = -float(y0_) * math.pi * 0.25
                out[n, i] = np.float32((_LANCZOS_CS[i][0] * s0
                                        + _LANCZOS_CS[i][1] * c0) / (y * y))
            else:
                out[n, i] = np.float32(1e30)
            total = np.float32(total + out[n, i])
        out[n] *= np.float32(1) / total
    return out


def _area_tab(n_in: int, n_out: int, scale: float) -> tuple[np.ndarray, np.ndarray]:
    """OpenCV's ``computeResizeAreaTab`` as [n_out, K] taps and weights, a
    row padded with weight-0 repeats of its last tap."""
    rows = []
    for dx in range(n_out):
        fsx1 = dx * scale
        fsx2 = fsx1 + scale
        cell = min(scale, n_in - fsx1)
        sx1, sx2 = math.ceil(fsx1), math.floor(fsx2)
        sx2 = min(sx2, n_in - 1)
        sx1 = min(sx1, sx2)
        taps = []
        if sx1 - fsx1 > 1e-3:
            taps.append((sx1 - 1, np.float32((sx1 - fsx1) / cell)))
        for sx in range(sx1, sx2):
            taps.append((sx, np.float32(1.0 / cell)))
        if fsx2 - sx2 > 1e-3:
            taps.append((sx2, np.float32(min(min(fsx2 - sx2, 1.0), cell) / cell)))
        rows.append(taps)
    k = max(len(t) for t in rows)
    idx = np.zeros((n_out, k), np.int64)
    w = np.zeros((n_out, k), np.float32)
    for dx, taps in enumerate(rows):
        for j in range(k):
            s, a = taps[min(j, len(taps) - 1)]
            idx[dx, j], w[dx, j] = s, (a if j < len(taps) else 0.0)
    return idx, w


@functools.lru_cache(maxsize=256)
def axis_taps(n_in: int, n_out: int, mode: str,
              area_downscale: bool = False) -> tuple[np.ndarray, np.ndarray]:
    """One axis of the resize: (source indices [n_out, K] int64, weights
    [n_out, K] float32), out[o] = sum_k w[o, k] * in[idx[o, k]] summed in k
    order. ``area_downscale``: both axes shrink, so ``area`` takes box
    weights (OpenCV decides this for the two axes together)."""
    if mode not in MODES:
        raise ValueError(f"unknown resize mode {mode!r}; one of {MODES}")
    scale = 1.0 / (n_out / n_in)  # OpenCV: scale = 1 / inv_scale, in double
    dx = np.arange(n_out, dtype=np.float64)
    if mode == "nearest":
        sx = np.minimum(np.floor(dx * (n_in / n_out)).astype(np.int64), n_in - 1)
        return sx[:, None], np.ones((n_out, 1), np.float32)
    if mode == "area" and area_downscale:
        return _area_tab(n_in, n_out, scale)
    if mode == "area":  # OpenCV's area-mode linear rule
        sx = np.floor(dx * scale).astype(np.int64)
        fx = ((dx + 1) - (sx + 1) * (n_out / n_in)).astype(np.float32)
        fx = np.where(fx <= 0, np.float32(0), fx - np.floor(fx)).astype(np.float32)
    else:
        pos = (dx + 0.5) * scale - 0.5
        if mode == "lanczos4":  # OpenCV rounds this one's position to float
            pos = pos.astype(np.float32)
        sx = np.floor(pos).astype(np.int64)
        fx = (pos - sx).astype(np.float32)
    if mode in ("linear", "area"):
        low = sx < 0
        fx[low], sx[low] = 0, 0
        high = sx >= n_in - 1
        fx[high], sx[high] = 0, n_in - 1
        w = np.stack([np.float32(1) - fx, fx], axis=1).astype(np.float32)
        return np.stack([sx, np.minimum(sx + 1, n_in - 1)], axis=1), w
    if mode == "cubic":
        w, first = _cubic_weights(fx), sx - 1
    else:
        w, first = _lanczos4_weights(fx), sx - 3
    idx = first[:, None] + np.arange(w.shape[1])[None]
    return np.clip(idx, 0, n_in - 1), w


def _resize_axis(x: torch.Tensor, dim: int, idx: np.ndarray,
                 w: np.ndarray) -> torch.Tensor:
    idx_t = torch.as_tensor(idx, device=x.device)
    w_t = torch.as_tensor(w, device=x.device).to(x.dtype)
    shape = [1] * x.ndim
    shape[dim] = idx.shape[0]
    out = None
    for k in range(idx.shape[1]):
        term = x.index_select(dim, idx_t[:, k]) * w_t[:, k].view(shape)
        out = term if out is None else out + term
    return out


def resize(x: torch.Tensor, size: tuple[int, int], mode: str = "linear") -> torch.Tensor:
    """[N, H, W, C] float -> [N, h, w, C] on x's device: what ``cv2.resize(img,
    (w, h), interpolation=...)`` gives each [H, W, C] float32 image."""
    if mode not in MODES:
        raise ValueError(f"unknown resize mode {mode!r}; one of {MODES}")
    if x.ndim != 4 or not x.is_floating_point():
        raise ValueError(f"resize takes a float [N, H, W, C] tensor, got "
                         f"{tuple(x.shape)} {x.dtype}")
    h, w = int(size[0]), int(size[1])
    H, W = x.shape[1], x.shape[2]
    if (h, w) == (H, W):
        return x
    shrink = h <= H and w <= W
    x = _resize_axis(x, 2, *axis_taps(W, w, mode, shrink))
    return _resize_axis(x, 1, *axis_taps(H, h, mode, shrink))
