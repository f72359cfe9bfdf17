"""Color correction: AdaIN and wavelet color transfer (NumPy).

The counterpart of ``dove_tpu/eval/color_fix.py`` (StableSR's color
corrector): match a generated frame's per-channel statistics (AdaIN) or its
low-frequency wavelet band to the source frame's. Inputs are [H, W, 3] or
[F, H, W, 3] float arrays in [0, 1]. The JAX package blurs with OpenCV's
``sepFilter2D``; this copy computes the same separable filter in NumPy
(OpenCV's default border, reflect-101), so it runs where OpenCV is missing.
"""

from __future__ import annotations

import numpy as np


def _stats(x: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Per-channel mean/std over all but the channel axis."""
    axes = tuple(range(x.ndim - 1))
    return x.mean(axis=axes), x.std(axis=axes) + 1e-8


def adain_color_fix(target: np.ndarray, source: np.ndarray) -> np.ndarray:
    """Re-normalize target's per-channel statistics to match source."""
    t_mean, t_std = _stats(target)
    s_mean, s_std = _stats(source)
    out = (target - t_mean) / t_std * s_std + s_mean
    return np.clip(out, 0.0, 1.0)


def _reflect101(n: int, radius: int) -> np.ndarray:
    """Source index of each position of an axis of length n padded by
    ``radius`` both sides, reflect-101 (OpenCV's BORDER_DEFAULT), repeated
    for pads longer than the axis."""
    idx = np.arange(-radius, n + radius)
    if n == 1:
        return np.zeros_like(idx)
    period = 2 * (n - 1)
    idx = np.mod(idx, period)
    return np.where(idx >= n, period - idx, idx)


def _gauss_blur(img: np.ndarray, radius: int) -> np.ndarray:
    """Separable dilated 3-tap blur (0.25, 0.5, 0.25 at -r, 0, +r) used by
    the wavelet decomposition, in float32 like the input."""
    frames = img if img.ndim == 4 else img[None]
    H, W = frames.shape[1], frames.shape[2]
    w = np.float32(0.25), np.float32(0.5)

    def tap3(x: np.ndarray, idx: np.ndarray, n: int, axis: int) -> np.ndarray:
        xp = np.take(x, idx, axis=axis)
        lo = np.take(xp, np.arange(0, n), axis=axis)
        mid = np.take(xp, np.arange(radius, radius + n), axis=axis)
        hi = np.take(xp, np.arange(2 * radius, 2 * radius + n), axis=axis)
        return (lo * w[0] + mid * w[1]) + hi * w[0]

    out = tap3(frames, _reflect101(W, radius), W, 2)  # rows first, as OpenCV
    out = tap3(out, _reflect101(H, radius), H, 1)
    return out.astype(img.dtype) if img.ndim == 4 else out[0].astype(img.dtype)


def wavelet_decomposition(
    img: np.ndarray, levels: int = 5
) -> tuple[np.ndarray, np.ndarray]:
    """(high_freq, low_freq) via iterative a-trous blurring."""
    high = np.zeros_like(img)
    low = img
    for i in range(levels):
        blurred = _gauss_blur(low, 2**i)
        high = high + (low - blurred)
        low = blurred
    return high, low


def wavelet_color_fix(target: np.ndarray, source: np.ndarray) -> np.ndarray:
    """Swap target's low-frequency band for source's (keeps the SR detail,
    restores the source's colors and illumination)."""
    t_high, _ = wavelet_decomposition(target)
    _, s_low = wavelet_decomposition(source)
    return np.clip(t_high + s_low, 0.0, 1.0)
