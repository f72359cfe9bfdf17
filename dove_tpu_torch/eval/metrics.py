"""Quality metrics for VSR evaluation: the counterpart of
``dove_tpu/eval/metrics.py``.

PSNR on RGB in [0, 1] and PSNR on the BT.601 luma are NumPy in float64, as
in the JAX package. SSIM (the MATLAB 11x11 sigma-1.5 Gaussian window on the
BT.601 Y channel at 0-255) runs in torch in float64 on a device, the card
unless the caller asks for the CPU: the five windowed sums of a clip are one
batched convolution instead of a NumPy sliding window per frame. LPIPS and
DISTS are the VGG16 distances of ``eval/vgg.py`` (weights from
``DOVE_LPIPS_WEIGHTS`` / ``DOVE_DISTS_WEIGHTS``). The no-reference metrics
score a clip alone: clipiqa (``eval/clip.py``, ``DOVE_CLIP_WEIGHTS``), niqe
(``eval/niqe.py``, ``DOVE_NIQE_PARAMS``), maniqa (``eval/maniqa.py``,
``DOVE_MANIQA_WEIGHTS``), musiq (``eval/musiq.py``, ``DOVE_MUSIQ_WEIGHTS``)
and ewarp, RAFT's warping error (``eval/ewarp.py``, ``DOVE_RAFT_WEIGHTS``).
Every learned metric runs on the card unless the caller asks for the CPU.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch
import torch.nn.functional as F

FULL_REFERENCE = ("psnr", "ssim", "lpips", "dists")


def _to_y(rgb: np.ndarray) -> np.ndarray:
    """[..., H, W, 3] RGB in [0,1] -> BT.601 luma in [0, 255]."""
    r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]
    return (65.481 * r + 128.553 * g + 24.966 * b) + 16.0


def psnr(pred: np.ndarray, gt: np.ndarray) -> float:
    """PSNR over RGB [0,1]; inputs [F, H, W, 3] (averaged per-frame)."""
    vals = []
    for p, g in zip(pred, gt):
        mse = np.mean((p.astype(np.float64) - g.astype(np.float64)) ** 2)
        vals.append(100.0 if mse == 0 else 10.0 * np.log10(1.0 / mse))
    return float(np.mean(vals))


def psnr_y(pred: np.ndarray, gt: np.ndarray) -> float:
    """PSNR on the BT.601 Y channel (range 0-255), averaged per frame."""
    vals = []
    for p, g in zip(pred, gt):
        mse = np.mean((_to_y(p) - _to_y(g)) ** 2)
        vals.append(100.0 if mse == 0 else 10.0 * np.log10(255.0**2 / mse))
    return float(np.mean(vals))


def _gaussian_kernel(size: int = 11, sigma: float = 1.5) -> np.ndarray:
    ax = np.arange(size) - size // 2
    g = np.exp(-(ax**2) / (2 * sigma**2))
    k = np.outer(g, g)
    return k / k.sum()


def ssim(pred: np.ndarray, gt: np.ndarray, device=None) -> float:
    """Mean per-frame SSIM on the Y channel; inputs [F, H, W, 3] in [0,1].
    MATLAB convention: 'valid' correlation with the Gaussian window, the
    constants of a 0-255 range; float64 on ``device`` (None: the card)."""
    from dove_tpu_torch.pipeline import resolve_device

    device = resolve_device(device)
    # luma in the input's precision, then float64, as the JAX package does
    p = torch.as_tensor(_to_y(np.asarray(pred)), dtype=torch.float64, device=device)
    g = torch.as_tensor(_to_y(np.asarray(gt)), dtype=torch.float64, device=device)
    k = torch.as_tensor(_gaussian_kernel(), device=device)[None, None]
    n = p.shape[0]
    # the five windowed statistics of every frame in one convolution
    stats = F.conv2d(torch.cat([p, g, p * p, g * g, p * g])[:, None], k)[:, 0]
    mu_p, mu_g, e_pp, e_gg, e_pg = stats.split(n)
    c1, c2 = (0.01 * 255) ** 2, (0.03 * 255) ** 2
    mu_p2, mu_g2, mu_pg = mu_p**2, mu_g**2, mu_p * mu_g
    ssim_map = ((2 * mu_pg + c1) * (2 * (e_pg - mu_pg) + c2)) / (
        (mu_p2 + mu_g2 + c1) * ((e_pp - mu_p2) + (e_gg - mu_g2) + c2))
    return float(ssim_map.mean(dim=(1, 2)).mean())


def match_resolution(pred: np.ndarray, gt: np.ndarray, mode: str = "top-left"):
    """Crop both sequences to the common (F, H, W): top-left or centered."""
    F_ = min(pred.shape[0], gt.shape[0])
    H = min(pred.shape[1], gt.shape[1])
    W = min(pred.shape[2], gt.shape[2])

    def crop(x):
        if mode == "center":
            h0 = (x.shape[1] - H) // 2
            w0 = (x.shape[2] - W) // 2
        else:
            h0 = w0 = 0
        return x[:F_, h0:h0 + H, w0:w0 + W]

    return crop(pred), crop(gt)


def get_metric(name: str, device=None) -> Callable:
    """A metric by name -> fn(pred, gt) for the full-reference ones, fn(pred)
    for the others. ``device`` is where the metrics past PSNR run (None: the
    card)."""
    name = name.lower()
    if name == "psnr":
        return psnr
    if name == "ssim":
        return lambda pred, gt: ssim(pred, gt, device)
    if name == "lpips":
        from dove_tpu_torch.eval.lpips import lpips_metric

        return lpips_metric(device)
    if name == "dists":
        from dove_tpu_torch.eval.dists import dists_metric

        return dists_metric(device)
    if name == "clipiqa":
        from dove_tpu_torch.eval.clip import clipiqa_metric

        return clipiqa_metric(device=device)
    if name == "niqe":
        from dove_tpu_torch.eval.niqe import niqe_metric

        return niqe_metric(device=device)
    if name == "maniqa":
        from dove_tpu_torch.eval.maniqa import maniqa_metric

        return maniqa_metric(device=device)
    if name == "musiq":
        from dove_tpu_torch.eval.musiq import musiq_metric

        return musiq_metric(device=device)
    if name in ("ewarp", "e*warp", "warping_error"):
        import os

        path = os.environ.get("DOVE_RAFT_WEIGHTS")
        if not path or not os.path.exists(path):
            raise NotImplementedError(
                "E*warp needs RAFT weights: set DOVE_RAFT_WEIGHTS to a local "
                "raft-things.pth (the reference uses the same checkpoint)"
            )
        from dove_tpu_torch.eval.ewarp import ewarp_clip
        from dove_tpu_torch.models.raft import load_raft
        from dove_tpu_torch.pipeline import resolve_device

        weights = load_raft(path, resolve_device(device))
        return lambda pred, _gt=None: ewarp_clip(weights, pred)
    raise ValueError(
        f"unknown metric '{name}'; available: psnr, ssim, lpips, dists, "
        "clipiqa, niqe, maniqa, musiq, ewarp"
    )


class MetricAccumulator:
    """Per-sample metric bookkeeping and averages, in the JAX package's JSON
    schema ({per_sample, average, count})."""

    def __init__(self, names: list[str], device=None):
        self.names = [n.lower() for n in names]
        self._fns = {n: get_metric(n, device) for n in self.names}
        self.per_sample: dict[str, list[float]] = {n: [] for n in self.names}
        self.sample_names: list[str] = []

    def add(self, name: str, pred: np.ndarray, gt: np.ndarray | None) -> dict:
        # every metric is computed before anything is recorded, so that a
        # failure on one sample leaves no list ragged against the count
        out = {}
        for metric in self.names:
            if metric in FULL_REFERENCE:
                if gt is None:
                    raise ValueError(f"metric {metric} needs --gt_dir")
                val = self._fns[metric](*match_resolution(pred, gt))
            else:
                val = self._fns[metric](pred)
            out[metric] = float(val)
        self.sample_names.append(name)
        for metric, val in out.items():
            self.per_sample[metric].append(val)
        return out

    def summary(self) -> dict:
        avg = {
            n: (float(np.mean(v)) if v else float("nan"))
            for n, v in self.per_sample.items()
        }
        return {
            "per_sample": self.per_sample,
            "average": avg,
            "count": len(self.sample_names),
        }
