"""VGG16 feature backbone and the LPIPS / DISTS perceptual metrics in PyTorch.

Counterpart of ``dove_tpu/eval/vgg.py``: the published formulations that the
reference scores and trains with (pyiqa's LPIPS and DISTS; the stage-2
perceptual loss of lora_one_s2_trainer.py:240-277):

  * LPIPS (Zhang et al. 2018, net='vgg'): inputs in [-1, 1], a fixed shift
    and scale, VGG16 relu{1_2,2_2,3_3,4_3,5_3} features, channel-unit-
    normalized squared differences through learned 1x1 "lin" heads, averaged
    over space and summed over stages;
  * DISTS (Ding et al. 2020): inputs in [0, 1], ImageNet normalization, VGG16
    stages with L2 (energy) pooling, per-channel alpha/beta-weighted
    SSIM-style mean and covariance similarity over 6 scales (the input and
    5 stages), distance = 1 - similarity.

Pretrained weights load from torch state-dict files (torchvision's
``features.*`` names for the backbone, lpips's ``lin{k}.model.1.weight`` or
``lins.{k}.model.1.weight`` and DISTS's ``alpha`` / ``beta`` for the heads),
or from ``.safetensors`` through the port's own reader.

The distances take [B, H, W, 3] images, the JAX package's layout; inside,
activations are NCHW for ``F.conv2d``. Everything is differentiable, so
``dists_distance`` doubles as the stage-2 training loss.
"""

from __future__ import annotations

import contextlib
from pathlib import Path
from typing import Mapping, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from dove_tpu_torch import safetensors_io

# VGG16 conv plan: (out_channels, layers) per stage, max-pool between stages
VGG16_STAGES = ((64, 2), (128, 2), (256, 3), (512, 3), (512, 3))

# LPIPS input normalization (on [-1, 1] inputs)
_LPIPS_SHIFT = (-0.030, -0.088, -0.188)
_LPIPS_SCALE = (0.458, 0.448, 0.450)

# DISTS / ImageNet normalization (on [0, 1] inputs)
_IMAGENET_MEAN = (0.485, 0.456, 0.406)
_IMAGENET_STD = (0.229, 0.224, 0.225)


class VGG16(nn.Module):
    """VGG16's thirteen 3x3 convs, grouped by stage (``VGG16_STAGES``)."""

    def __init__(self, device=None, dtype=None):
        super().__init__()
        stages, cin = [], 3
        for cout, layers in VGG16_STAGES:
            convs = []
            for _ in range(layers):
                convs.append(nn.Conv2d(cin, cout, 3, padding=1, device=device,
                                       dtype=dtype))
                cin = cout
            stages.append(nn.ModuleList(convs))
        self.stages = nn.ModuleList(stages)


# ---------------------------------------------------------------------------
# Backbone
# ---------------------------------------------------------------------------

def _l2_pool(x: torch.Tensor) -> torch.Tensor:
    """Energy pooling (DISTS): sqrt of the hann-windowed average of squares,
    stride 2. The JAX package runs it as a dense C -> C convolution whose
    kernel is the identity over channels; this depthwise one (groups=C)
    computes the same function with the same nonzero terms, only the exact
    zeros of the dense kernel drop out."""
    w1 = np.hanning(5)[1:-1]  # [0.5, 1.0, 0.5]
    w2 = np.outer(w1, w1)
    w2 = torch.as_tensor((w2 / w2.sum()).astype(np.float32), device=x.device)
    C = x.shape[1]
    kernel = w2.to(x.dtype).expand(C, 1, 3, 3)
    sq = F.conv2d(x * x, kernel, stride=2, padding=1, groups=C)
    return torch.sqrt(torch.clamp_min(sq, 1e-12))


def vgg16_features(vgg: VGG16, x: torch.Tensor, pool: str = "max") -> list[torch.Tensor]:
    """x: [B, 3, H, W] (normalized) -> the 5 stage outputs (after each
    stage's last relu, before its pool), NCHW."""
    feats = []
    h = x
    for si, stage in enumerate(vgg.stages):
        for conv in stage:
            h = F.relu(conv(h))
        feats.append(h)
        if si < len(vgg.stages) - 1:
            h = F.max_pool2d(h, 2) if pool == "max" else _l2_pool(h)
    return feats


@torch.no_grad()
def init_vgg16(seed: int = 0, device="cpu", dtype=torch.float32) -> VGG16:
    """A VGG16 with seeded random weights, the distribution of the JAX
    package's ``init_vgg16``: kernels normal with std sqrt(2 / (9 cin)),
    biases 0. The draws come from a ``torch.Generator`` seeded with ``seed``
    and differ from those of JAX's ``PRNGKey``; tests that need both packages
    on one set of weights carry JAX's across with ``weights.from_jax_vgg``."""
    with torch.device("meta"):
        vgg = VGG16(dtype=dtype)
    vgg = vgg.to_empty(device=device)
    gen = torch.Generator(device=device).manual_seed(seed)
    for stage in vgg.stages:
        for conv in stage:
            cin = conv.in_channels
            conv.weight.normal_(0.0, (2.0 / (9 * cin)) ** 0.5, generator=gen)
            conv.bias.zero_()
    return vgg.eval().requires_grad_(False)


def vgg_from_kernels(convs: Sequence[tuple[torch.Tensor, torch.Tensor]],
                     device="cpu") -> VGG16:
    """The 13 (weight [Cout, Cin, 3, 3], bias [Cout]) pairs, in order -> a
    frozen fp32 VGG16."""
    if len(convs) != sum(n for _, n in VGG16_STAGES):
        raise ValueError(f"VGG16 has 13 convs, got {len(convs)}")
    with torch.device("meta"):
        vgg = VGG16(dtype=torch.float32)
    vgg = vgg.to_empty(device=device)
    mods = [conv for stage in vgg.stages for conv in stage]
    with torch.no_grad():
        for mod, (w, b) in zip(mods, convs):
            mod.weight.copy_(torch.as_tensor(w))
            mod.bias.copy_(torch.as_tensor(b))
    return vgg.eval().requires_grad_(False)


def vgg16_from_torch_sd(sd: Mapping[str, torch.Tensor | np.ndarray],
                        device="cpu") -> VGG16:
    """torchvision VGG16 ``features.{idx}.weight`` layout -> a VGG16.

    Also takes pyiqa/lpips-style prefixed keys (``net.slice*``) by sorting
    every 3x3 conv kernel by name, as the JAX package does."""
    sd = {k: torch.as_tensor(v) for k, v in sd.items()}
    if any(k.startswith("features.") for k in sd):
        idxs = sorted(
            int(k.split(".")[1]) for k in sd
            if k.startswith("features.") and k.endswith(".weight") and sd[k].ndim == 4
        )
        convs = [(sd[f"features.{i}.weight"], sd[f"features.{i}.bias"]) for i in idxs]
    else:
        ws = [k for k in sorted(sd) if k.endswith(".weight") and sd[k].ndim == 4
              and tuple(sd[k].shape[2:]) == (3, 3)]
        convs = [(sd[k], sd[k.replace(".weight", ".bias")]) for k in ws]
    return vgg_from_kernels(convs[:13], device)


# ---------------------------------------------------------------------------
# LPIPS
# ---------------------------------------------------------------------------

def _unit_normalize(f: torch.Tensor) -> torch.Tensor:
    norm = torch.sqrt(torch.sum(f * f, dim=1, keepdim=True))
    return f / (norm + 1e-10)


def _nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


def lpips_distance(vgg: VGG16, lins: Sequence[torch.Tensor], x: torch.Tensor,
                   y: torch.Tensor) -> torch.Tensor:
    """x, y: [B, H, W, 3] in [-1, 1]; lins: per stage [C] non-negative 1x1
    weights -> [B] LPIPS distances."""
    shift = torch.tensor(_LPIPS_SHIFT, dtype=x.dtype, device=x.device)
    scale = torch.tensor(_LPIPS_SCALE, dtype=x.dtype, device=x.device)
    fx = vgg16_features(vgg, _nchw((x - shift) / scale))
    fy = vgg16_features(vgg, _nchw((y - shift) / scale))
    total = 0.0
    for f1, f2, w in zip(fx, fy, lins):
        d = (_unit_normalize(f1.float()) - _unit_normalize(f2.float())) ** 2
        total = total + torch.sum(d * w.view(1, -1, 1, 1), dim=1).mean(dim=(1, 2))
    return total


# ---------------------------------------------------------------------------
# DISTS
# ---------------------------------------------------------------------------

def dists_distance(vgg: VGG16, alpha: Sequence[torch.Tensor],
                   beta: Sequence[torch.Tensor], x: torch.Tensor,
                   y: torch.Tensor) -> torch.Tensor:
    """x, y: [B, H, W, 3] in [0, 1]; alpha, beta: 6 scales of per-channel
    weights -> [B] DISTS distances."""
    mean = torch.tensor(_IMAGENET_MEAN, dtype=x.dtype, device=x.device)
    std = torch.tensor(_IMAGENET_STD, dtype=x.dtype, device=x.device)
    xn, yn = _nchw((x - mean) / std), _nchw((y - mean) / std)
    fx = [xn] + vgg16_features(vgg, xn, pool="l2")
    fy = [yn] + vgg16_features(vgg, yn, pool="l2")

    w_sum = sum(a.sum() for a in alpha) + sum(b.sum() for b in beta)
    c1 = c2 = 1e-6
    score = 0.0
    for f1, f2, a, b in zip(fx, fy, alpha, beta):
        f1, f2 = f1.float(), f2.float()
        mu1 = f1.mean(dim=(2, 3))
        mu2 = f2.mean(dim=(2, 3))
        var1 = (f1 * f1).mean(dim=(2, 3)) - mu1**2
        var2 = (f2 * f2).mean(dim=(2, 3)) - mu2**2
        cov = (f1 * f2).mean(dim=(2, 3)) - mu1 * mu2
        s1 = (2 * mu1 * mu2 + c1) / (mu1**2 + mu2**2 + c1)
        s2 = (2 * cov + c2) / (var1 + var2 + c2)
        score = score + torch.sum(a * s1 + b * s2, dim=-1)
    return 1.0 - score / w_sum


def init_dists_weights(vgg_stages=VGG16_STAGES, device="cpu"):
    """Uniform alpha and beta: ones at every channel of every scale."""
    chans = [3] + [c for c, _ in vgg_stages]
    alpha = [torch.ones((c,), dtype=torch.float32, device=device) for c in chans]
    beta = [torch.ones((c,), dtype=torch.float32, device=device) for c in chans]
    return alpha, beta


def dists_heads(sd: Mapping[str, torch.Tensor], device="cpu"):
    """DISTS's flat ``alpha`` / ``beta`` -> the 6 per-scale vectors each."""
    chans = [3] + [c for c, _ in VGG16_STAGES]
    flat = [torch.as_tensor(sd[k]).reshape(-1).float().to(device)
            for k in ("alpha", "beta")]
    bounds = np.cumsum([0] + chans)
    return tuple([f[s:e] for s, e in zip(bounds[:-1], bounds[1:])] for f in flat)


LPIPS_HEAD_KEYS = ("lins.{k}.model.1.weight", "lin{k}.model.1.weight")


def lpips_head(sd: Mapping[str, torch.Tensor], k: int, keys=LPIPS_HEAD_KEYS,
               device="cpu") -> torch.Tensor | None:
    """Stage k's 1x1 lin head ([1, C, 1, 1] in the file) as [C], under the
    first of ``keys`` the file has, or None."""
    for key in keys:
        if key.format(k=k) in sd:
            return torch.as_tensor(sd[key.format(k=k)])[:, :, 0, 0][0].float().to(device)
    return None


# ---------------------------------------------------------------------------
# Weight files (torch state dicts exported from pyiqa / lpips / DISTS)
# ---------------------------------------------------------------------------

def _read_state_dict(path: str | Path) -> dict[str, torch.Tensor]:
    """A state dict file -> {name: CPU tensor}: ``.safetensors`` through the
    port's reader, anything else through ``torch.load``."""
    path = Path(path)
    if path.suffix == ".safetensors":
        return safetensors_io.load_file(path)
    sd = torch.load(str(path), map_location="cpu", weights_only=True)
    if hasattr(sd, "state_dict"):
        sd = sd.state_dict()
    return dict(sd)


# frames per VGG16 pass of a metric: a 720p frame's first-stage features
# are 236 MB in fp32, so a clip goes through in slices
METRIC_FRAMES = 8


@contextlib.contextmanager
def full_fp32():
    """cuDNN's convolutions and cuBLAS's fp32 products in full fp32 (no TF32,
    which PyTorch allows for convolutions by default) inside the block, so
    that a score does not depend on the process's settings."""
    cudnn = torch.backends.cudnn
    matmul = torch.backends.cuda.matmul
    saved = matmul.allow_tf32
    matmul.allow_tf32 = False
    try:
        with cudnn.flags(enabled=cudnn.enabled, benchmark=cudnn.benchmark,
                         deterministic=cudnn.deterministic, allow_tf32=False):
            yield
    finally:
        matmul.allow_tf32 = saved


def _per_frame_mean(distance, pred: np.ndarray, gt: np.ndarray, device) -> float:
    """The mean over frames of distance(x, y) -> [n] on [n, H, W, 3] fp32
    slices of ``METRIC_FRAMES`` frames on ``device``, in full fp32."""
    vals = []
    with full_fp32():
        for s in range(0, len(pred), METRIC_FRAMES):
            x = torch.as_tensor(np.asarray(pred[s:s + METRIC_FRAMES], np.float32),
                                device=device)
            y = torch.as_tensor(np.asarray(gt[s:s + METRIC_FRAMES], np.float32),
                                device=device)
            vals.append(distance(x, y))
    return float(torch.cat(vals).mean())


def load_lpips(path: str | Path, device=None):
    """An exported lpips(net='vgg') state dict -> metric (pred, gt) -> float;
    videos enter as [F, H, W, 3] in [0, 1]. Runs on the card unless
    ``device`` says otherwise."""
    from dove_tpu_torch.pipeline import resolve_device

    device = resolve_device(device)
    sd = _read_state_dict(path)
    vgg = vgg16_from_torch_sd(sd, device)
    lins = []
    for k in range(5):
        w = lpips_head(sd, k, device=device)
        if w is None:
            raise KeyError(f"no lin head {k} in {path}")
        lins.append(w)

    @torch.no_grad()
    def metric(pred: np.ndarray, gt: np.ndarray) -> float:
        return _per_frame_mean(
            lambda x, y: lpips_distance(vgg, lins, x * 2 - 1, y * 2 - 1),
            pred, gt, device)

    return metric


def load_dists(path: str | Path, device=None):
    """An exported DISTS state dict -> metric (pred, gt) -> float; videos
    enter as [F, H, W, 3] in [0, 1]. Runs on the card unless ``device`` says
    otherwise."""
    from dove_tpu_torch.pipeline import resolve_device

    device = resolve_device(device)
    sd = _read_state_dict(path)
    vgg = vgg16_from_torch_sd(sd, device)
    alpha, beta = dists_heads(sd, device)

    @torch.no_grad()
    def metric(pred: np.ndarray, gt: np.ndarray) -> float:
        return _per_frame_mean(
            lambda x, y: dists_distance(vgg, alpha, beta, x, y), pred, gt, device)

    return metric
