"""NIQE, the Natural Image Quality Evaluator (no-reference), in PyTorch.

Counterpart of ``dove_tpu/eval/niqe.py`` (Mittal et al., IEEE SPL 2013,
MATLAB / pyiqa conventions), run on a device in float64:

  1. BT.601 grey on [0, 255] (in the frame's float32, as the JAX package
     computes it), MSCN coefficients through a 7x7 Gaussian of sigma 7/6
     with replicated borders (what ``cv2.GaussianBlur`` computes there);
  2. per 96x96 patch 18 NSS features: the (A)GGD fit of the MSCN field and
     the AGGD fits of its four pairwise products (H, V, D1, D2, each shifted
     circularly within the patch), every patch of a slice of frames at once;
     the fits are argmins over the same grid of shapes as the JAX package's;
  3. the same on the MATLAB-bicubic half-size image (48x48 patches); the
     patches below 0.75x the peak local sharpness dropped;
  4. the distance of the features' Gaussian to the pristine model's.

The pristine model is a fitted artifact: ``DOVE_NIQE_PARAMS`` names a
``.npz`` with ``mu`` [36] and ``cov`` [36, 36] or the original
``niqe_image_params.mat`` (read with scipy).
"""

from __future__ import annotations

import functools
import math
import os

import numpy as np
import torch
import torch.nn.functional as F

# (A)GGD moment matching: the grid of shape parameters and its ratios
_GAM = np.arange(0.2, 10.001, 0.001)
_GAMMA = np.vectorize(math.gamma)
_R_GAM = (_GAMMA(2.0 / _GAM) ** 2) / (_GAMMA(1.0 / _GAM) * _GAMMA(3.0 / _GAM))
# per grid point: sqrt(gamma(1/a) / gamma(3/a)) and gamma(2/a) / gamma(1/a)
_CONV = np.asarray([math.sqrt(math.gamma(1.0 / a) / math.gamma(3.0 / a)) for a in _GAM])
_MEAN_RATIO = np.asarray([math.gamma(2.0 / a) / math.gamma(1.0 / a) for a in _GAM])

BLOCK = 96
# frames per device pass (a 720p frame's fields are ~7 MB each in float64)
NIQE_FRAMES = 8


@functools.lru_cache(maxsize=8)
def _tables(device) -> dict[str, torch.Tensor]:
    return {name: torch.as_tensor(t, dtype=torch.float64, device=device)
            for name, t in (("gam", _GAM), ("r_gam", _R_GAM), ("conv", _CONV),
                            ("mean_ratio", _MEAN_RATIO))}


def estimate_aggd(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                                              torch.Tensor]:
    """[P, N] float64 -> (grid index, alpha, beta_l, beta_r), each [P]: the
    JAX package's ``estimate_aggd`` on every row."""
    t = _tables(x.device)
    neg, pos = x < 0, x > 0
    sq = x * x
    n_neg, n_pos = neg.sum(-1), pos.sum(-1)
    left_std = torch.where(
        n_neg > 0, torch.sqrt((sq * neg).sum(-1) / n_neg.clamp(min=1)), 0.0)
    right_std = torch.where(
        n_pos > 0, torch.sqrt((sq * pos).sum(-1) / n_pos.clamp(min=1)), 0.0)
    inf = torch.tensor(float("inf"), dtype=x.dtype, device=x.device)
    gammahat = torch.where(right_std > 0, left_std / right_std, inf)
    m1 = x.abs().mean(-1)
    m2 = sq.mean(-1)
    rhat = torch.where(m2 > 0, m1 * m1 / m2, inf)
    g = gammahat
    rhatnorm = torch.where(torch.isfinite(g),
                           rhat * (g ** 3 + 1) * (g + 1) / ((g ** 2 + 1) ** 2), inf)
    idx = ((t["r_gam"][None] - rhatnorm[:, None]) ** 2).argmin(-1)
    conv = t["conv"][idx]
    return idx, t["gam"][idx], left_std * conv, right_std * conv


def patch_features(mscn: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """[P, b, b] MSCN patches -> ([P, 18] NSS features, [P, 5] the grid
    index of each of their five fits)."""
    P = mscn.shape[0]
    idx, alpha, bl, br = estimate_aggd(mscn.reshape(P, -1))
    feats, idxs = [alpha, (bl + br) / 2.0], [idx]
    t = _tables(mscn.device)
    for dy, dx in ((0, 1), (1, 0), (1, 1), (1, -1)):  # H, V, D1, D2
        prod = mscn * torch.roll(mscn, shifts=(dy, dx), dims=(1, 2))
        i, a, left, right = estimate_aggd(prod.reshape(P, -1))
        feats += [a, (right - left) * t["mean_ratio"][i], left, right]
        idxs.append(i)
    return torch.stack(feats, -1), torch.stack(idxs, -1)


@functools.lru_cache(maxsize=8)
def _gaussian_7(device) -> torch.Tensor:
    """cv2.getGaussianKernel(7, 7/6) in double."""
    x = np.arange(7, dtype=np.float64) - 3.0
    k = np.exp(-(x * x) / (2 * (7.0 / 6.0) ** 2))
    return torch.as_tensor(k / k.sum(), device=device)


def _blur(x: torch.Tensor) -> torch.Tensor:
    """[N, H, W] float64 -> the 7x7 Gaussian blur, replicated borders; rows
    first, then columns, as OpenCV's separable filter runs."""
    k = _gaussian_7(x.device)
    y = F.pad(x[:, None], (3, 3, 3, 3), mode="replicate")
    y = F.conv2d(y, k.view(1, 1, 1, 7))
    return F.conv2d(y, k.view(1, 1, 7, 1))[:, 0]


def mscn(gray: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """[N, H, W] float64 -> (MSCN coefficients, local deviation sigma)."""
    mu = _blur(gray)
    sigma = torch.sqrt(torch.clamp(_blur(gray * gray) - mu * mu, min=0.0))
    return (gray - mu) / (sigma + 1.0), sigma


def _cubic(t: np.ndarray) -> np.ndarray:
    a = np.abs(t)
    return np.where(a <= 1, 1.5 * a**3 - 2.5 * a**2 + 1,
                    np.where(a < 2, -0.5 * a**3 + 2.5 * a**2 - 4 * a + 2, 0.0))


@functools.lru_cache(maxsize=16)
def _half_weights(n_in: int) -> tuple[np.ndarray, np.ndarray]:
    """MATLAB ``contributions()`` for imresize(0.5, 'bicubic') with its
    antialiasing: (indices [n_out, 10], weights [n_out, 10])."""
    scale = 0.5
    n_out = int(np.ceil(n_in * scale))
    x = np.arange(1, n_out + 1, dtype=np.float64)
    u = x / scale + 0.5 * (1 - 1 / scale)
    left = np.floor(u - 4).astype(int)
    idx = left[:, None] + np.arange(10)[None, :]
    w = scale * _cubic(scale * (u[:, None] - idx))
    w /= w.sum(axis=1, keepdims=True)
    return np.clip(idx - 1, 0, n_in - 1), w


def matlab_bicubic_half(img: torch.Tensor) -> torch.Tensor:
    """[N, H, W] float64 -> imresize(img, 0.5, 'bicubic'), MATLAB semantics
    (the weights computed on the host as the JAX package computes them)."""
    for dim in (1, 2):
        idx, w = _half_weights(img.shape[dim])
        idx_t = torch.as_tensor(idx, device=img.device)
        w_t = torch.as_tensor(w, device=img.device)
        moved = img.movedim(dim, 1)  # [N, n_in, other]
        taps = moved[:, idx_t]  # [N, n_out, 10, other]
        img = (w_t[None, :, :, None] * taps).sum(2).movedim(1, dim)
    return img


def _patches(x: torch.Tensor, b: int, ny: int, nx: int) -> torch.Tensor:
    """[N, ny*b, nx*b] -> [N, ny*nx, b, b], row-major over the blocks."""
    N = x.shape[0]
    return (x.reshape(N, ny, b, nx, b).permute(0, 1, 3, 2, 4)
            .reshape(N, ny * nx, b, b))


def niqe_features(gray: torch.Tensor, block: int = BLOCK):
    """[N, H, W] grey in [0, 255], float64 -> (features [N, ny*nx, 36],
    the sharpness keep mask [N, ny*nx], the fits' grid indices [N, ny*nx,
    10])."""
    N, h, w = gray.shape
    ny, nx = h // block, w // block
    if ny == 0 or nx == 0:
        raise ValueError(f"image {tuple(gray.shape[1:])} smaller than NIQE block {block}")
    gray = gray[:, : ny * block, : nx * block]
    mscn1, sigma = mscn(gray)
    mscn2, _ = mscn(matlab_bicubic_half(gray))
    p1 = _patches(mscn1, block, ny, nx).reshape(N * ny * nx, block, block)
    p2 = _patches(mscn2, block // 2, ny, nx).reshape(N * ny * nx, block // 2, block // 2)
    f1, i1 = patch_features(p1)
    f2, i2 = patch_features(p2)
    feats = torch.cat([f1, f2], -1).reshape(N, ny * nx, 36)
    idxs = torch.cat([i1, i2], -1).reshape(N, ny * nx, 10)
    sharp = _patches(sigma, block, ny, nx).mean(dim=(2, 3))  # [N, ny*nx]
    keep = sharp > 0.75 * sharp.amax(dim=1, keepdim=True)
    keep = keep | ~keep.any(dim=1, keepdim=True)
    return feats, keep, idxs


def mvg_distance(feats: torch.Tensor, mu_pris: torch.Tensor,
                 cov_pris: torch.Tensor) -> float:
    """[n, 36] features of one frame -> the distance of their Gaussian to
    the pristine one (NaN rows dropped; NaN when none is left)."""
    feats = feats[~torch.isnan(feats).any(dim=1)]
    if feats.shape[0] == 0:
        return float("nan")
    mu_d = feats.mean(0)
    cov_d = (torch.cov(feats.T) if feats.shape[0] > 1
             else torch.zeros_like(cov_pris))
    diff = (mu_pris - mu_d)[None]
    inv = torch.linalg.pinv((cov_pris + cov_d) / 2.0, rtol=1e-15)
    return float(torch.sqrt(torch.clamp((diff @ inv @ diff.T)[0, 0], min=0.0)))


def to_gray255(rgb01: torch.Tensor) -> torch.Tensor:
    """[..., 3] RGB in [0, 1] -> BT.601 grey in [0, 255] (MATLAB rgb2gray),
    in the input's precision."""
    r, g, b = rgb01[..., 0], rgb01[..., 1], rgb01[..., 2]
    return torch.clamp((0.299 * r + 0.587 * g + 0.114 * b) * 255.0, 0, 255)


def niqe_scores(frames: np.ndarray, mu: torch.Tensor, cov: torch.Tensor,
                device) -> list[float]:
    """[F, H, W, 3] in [0, 1] -> the NIQE of each frame, ``NIQE_FRAMES`` a
    pass."""
    out = []
    for s in range(0, len(frames), NIQE_FRAMES):
        x = torch.as_tensor(np.asarray(frames[s:s + NIQE_FRAMES]), device=device)
        feats, keep, _ = niqe_features(to_gray255(x).double())
        out += [mvg_distance(f[k], mu, cov) for f, k in zip(feats, keep)]
    return out


def load_niqe_params(path: str | None = None) -> tuple[np.ndarray, np.ndarray]:
    path = path or os.environ.get("DOVE_NIQE_PARAMS")
    if not path or not os.path.exists(path):
        raise NotImplementedError(
            "NIQE needs its fitted pristine-model parameters: set "
            "DOVE_NIQE_PARAMS to a .npz with mu [36] / cov [36,36] (export "
            "from pyiqa's niqe pretrained params) or the original "
            "niqe_image_params.mat"
        )
    if path.endswith(".mat"):
        from scipy.io import loadmat

        m = loadmat(path)
        return (np.asarray(m["mu_prisparam"], np.float64).ravel(),
                np.asarray(m["cov_prisparam"], np.float64))
    z = np.load(path)
    return np.asarray(z["mu"], np.float64).ravel(), np.asarray(z["cov"], np.float64)


def niqe_metric(params_path: str | None = None, device=None):
    """-> fn(pred [F, H, W, 3] in [0, 1]) -> the mean per-frame NIQE (lower
    is better), on the card unless ``device`` says otherwise."""
    from dove_tpu_torch.pipeline import resolve_device

    mu, cov = load_niqe_params(params_path)
    device = resolve_device(device)
    mu_t = torch.as_tensor(mu, device=device)
    cov_t = torch.as_tensor(cov, device=device)

    def fn(pred: np.ndarray, _gt=None) -> float:
        return float(np.mean(niqe_scores(pred, mu_t, cov_t, device)))

    return fn
