"""MUSIQ, the multi-scale image quality transformer (no-reference), in
PyTorch.

Counterpart of ``dove_tpu/eval/musiq.py`` (Ke et al., ICCV 2021):

  * the frame at its own size plus aspect-ratio-preserving (ARP) resizes to
    a longer side of 224 and 384, by ``ops/resize.py``'s ``linear``
    (OpenCV's INTER_LINEAR, which the JAX package calls);
  * 32x32 patches of each scale (zero-padded to whole patches), projected
    to D = 384, plus a hash-based spatial embedding (cell (i, j) of an
    (n_rows, n_cols) grid reads a G x G table at (floor(i G / n_rows),
    floor(j G / n_cols)), G = 10) and a per-scale embedding (0 the native
    size, then the ARP sides in order);
  * a CLS token, 14 pre-LN layers (6 heads, MLP 1152), a final LayerNorm
    and a one-logit head on the CLS token (higher is better).

Every frame of a clip has the same size, hence the same tokens' layout, so
the frames go through the transformer in slices of ``MUSIQ_FRAMES``, in
fp32 without TF32, on the card unless the caller passes ``device``.

Weights-gated: ``DOVE_MUSIQ_WEIGHTS`` names an exported torch state dict in
the canonical layout of :func:`convert_state_dict`, which reports every
unmatched key. ``DOVE_MUSIQ_INPUT=byte`` feeds [0, 255] instead of [0, 1].
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any, Mapping

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from dove_tpu_torch.eval.clip import attention, f32, load_tensors

# frames per transformer pass (a 720p frame is ~1,030 tokens)
MUSIQ_FRAMES = 8


@dataclasses.dataclass(frozen=True)
class MUSIQConfig:
    patch_size: int = 32
    hidden: int = 384
    num_layers: int = 14
    num_heads: int = 6
    mlp_dim: int = 1152
    hse_grid: int = 10  # hash-based spatial embedding grid (G x G)
    longer_sides: tuple = (224, 384)  # ARP scales; native rides along
    num_class: int = 1
    eps: float = 1e-6
    # cap on native-scale patches (0 = unlimited)
    max_native_patches: int = 0

    @property
    def num_scales(self) -> int:
        return 1 + len(self.longer_sides)

    @property
    def patch_dim(self) -> int:
        return 3 * self.patch_size * self.patch_size


# --- multi-scale tokens ------------------------------------------------------

def arp_size(h: int, w: int, longer: int) -> tuple[int, int]:
    """The ARP resize's (height, width): max(H, W) becomes ``longer``."""
    scale = longer / max(h, w)
    return max(int(round(h * scale)), 1), max(int(round(w * scale)), 1)


def hse_index(cfg: MUSIQConfig, n_rows: int, n_cols: int) -> np.ndarray:
    """[n_rows * n_cols] spatial-embedding rows of a patch grid."""
    G = cfg.hse_grid
    ii, jj = np.meshgrid(np.arange(n_rows), np.arange(n_cols), indexing="ij")
    gi = np.minimum((ii * G) // n_rows, G - 1)
    gj = np.minimum((jj * G) // n_cols, G - 1)
    return (gi * G + gj).reshape(-1)


def grid_patches(cfg: MUSIQConfig, img: torch.Tensor) -> tuple[torch.Tensor, np.ndarray]:
    """[B, H, W, 3] -> (patches [B, N, 3 P^2], hse index [N]), zero-padded
    to whole patches; N = ceil(H/P) * ceil(W/P), row-major."""
    P = cfg.patch_size
    B, h, w, C = img.shape
    n_rows, n_cols = -(-h // P), -(-w // P)
    pad = F.pad(img, (0, 0, 0, n_cols * P - w, 0, n_rows * P - h))
    patches = (pad.reshape(B, n_rows, P, n_cols, P, C).permute(0, 1, 3, 2, 4, 5)
               .reshape(B, n_rows * n_cols, P * P * C))
    return patches, hse_index(cfg, n_rows, n_cols)


def multiscale_tokens(cfg: MUSIQConfig, frames: torch.Tensor):
    """[B, H, W, 3] float in [0, 1] -> (patches [B, N, 3 P^2], hse index
    [N], scale index [N]) across the native and ARP scales."""
    from dove_tpu_torch.ops.resize import resize

    if os.environ.get("DOVE_MUSIQ_INPUT", "unit") == "byte":
        frames = frames * 255.0
    h, w = frames.shape[1:3]
    scales = [frames] + [resize(frames, arp_size(h, w, L), "linear")
                         for L in cfg.longer_sides]
    parts, hse, scale_idx = [], [], []
    for s_idx, img in enumerate(scales):
        p, g = grid_patches(cfg, img)
        if s_idx == 0 and cfg.max_native_patches and p.shape[1] > cfg.max_native_patches:
            keep = np.linspace(0, p.shape[1] - 1, cfg.max_native_patches).astype(int)
            p, g = p[:, torch.as_tensor(keep, device=p.device)], g[keep]
        parts.append(p)
        hse.append(g)
        scale_idx.append(np.full(p.shape[1], s_idx, np.int64))
    return torch.cat(parts, 1), np.concatenate(hse), np.concatenate(scale_idx)


# --- the transformer -----------------------------------------------------------

class Block(nn.Module):
    """Pre-LN block: fused-qkv multi-head attention, exact-GELU MLP."""

    def __init__(self, dim: int, heads: int, mlp: int, eps: float):
        super().__init__()
        self.heads = heads
        self.norm1 = nn.LayerNorm(dim, eps=eps)
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)
        self.norm2 = nn.LayerNorm(dim, eps=eps)
        self.fc1 = nn.Linear(dim, mlp)
        self.fc2 = nn.Linear(mlp, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, S, D = x.shape
        qkv = self.qkv(self.norm1(x)).view(B, S, 3, self.heads, -1).permute(2, 0, 3, 1, 4)
        o = attention(qkv[0], qkv[1], qkv[2])
        x = x + self.proj(o.transpose(1, 2).reshape(B, S, D))
        return x + self.fc2(F.gelu(self.fc1(self.norm2(x))))


class MUSIQ(nn.Module):
    def __init__(self, cfg: MUSIQConfig):
        super().__init__()
        self.cfg = cfg
        D = cfg.hidden
        self.embedding = nn.Linear(cfg.patch_dim, D)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, D))
        self.spatial_embedding = nn.Parameter(torch.zeros(cfg.hse_grid ** 2, D))
        self.scale_embedding = nn.Parameter(torch.zeros(cfg.num_scales, D))
        self.blocks = nn.ModuleList(Block(D, cfg.num_heads, cfg.mlp_dim, cfg.eps)
                                    for _ in range(cfg.num_layers))
        self.norm = nn.LayerNorm(D, eps=cfg.eps)
        self.head = nn.Linear(D, cfg.num_class)

    def forward(self, patches: torch.Tensor, hse_idx: np.ndarray,
                scale_idx: np.ndarray) -> torch.Tensor:
        """patches [B, N, 3 P^2] -> the quality logits [B]."""
        dev = patches.device
        tok = self.embedding(patches)
        tok = tok + self.spatial_embedding[torch.as_tensor(hse_idx, device=dev)]
        tok = tok + self.scale_embedding[torch.as_tensor(scale_idx, device=dev)]
        x = torch.cat([self.cls_token.reshape(1, 1, -1).expand(tok.shape[0], 1, -1),
                       tok], dim=1)
        for blk in self.blocks:
            x = blk(x)
        return self.head(self.norm(x)[:, 0]).reshape(-1)


def musiq_scores(model: MUSIQ, frames: np.ndarray, device) -> torch.Tensor:
    """[F, H, W, 3] in [0, 1] -> the per-frame logits [F]."""
    from dove_tpu_torch.eval.vgg import full_fp32

    out = []
    with full_fp32():
        for s in range(0, len(frames), MUSIQ_FRAMES):
            x = torch.as_tensor(np.asarray(frames[s:s + MUSIQ_FRAMES], np.float32),
                                device=device)
            out.append(model(*multiscale_tokens(model.cfg, x)))
    return torch.cat(out)


# --- parameters ----------------------------------------------------------------

def _frozen(model: nn.Module, device) -> nn.Module:
    return model.eval().requires_grad_(False).to(device)


def from_jax_musiq(params: Mapping[str, Any], cfg: MUSIQConfig, device="cpu") -> MUSIQ:
    """``init_musiq_params`` / ``convert_state_dict``'s tree (NumPy leaves,
    [in, out] weights) -> a frozen fp32 MUSIQ."""
    out = {}

    def lin(name, p):
        out[f"{name}.weight"] = f32(p["weight"]).T
        if "bias" in p:
            out[f"{name}.bias"] = f32(p["bias"])

    def ln(name, p):
        out[f"{name}.weight"], out[f"{name}.bias"] = f32(p["weight"]), f32(p["bias"])

    lin("embedding", params["embedding"])
    lin("head", params["head"])
    ln("norm", params["norm"])
    for name in ("cls_token", "spatial_embedding", "scale_embedding"):
        out[name] = f32(params[name])
    for i, blk in enumerate(params["blocks"]):
        for name in ("qkv", "proj", "fc1", "fc2"):
            lin(f"blocks.{i}.{name}", blk[name])
        for name in ("norm1", "norm2"):
            ln(f"blocks.{i}.{name}", blk[name])
    model = MUSIQ(cfg)
    load_tensors(model, out)
    return _frozen(model, device)


def convert_state_dict(sd: Mapping[str, Any], cfg: MUSIQConfig | None = None,
                       device="cpu") -> MUSIQ:
    """A torch state dict in the canonical flat layout (torch Linear
    convention, [out, in] weights) -> a frozen fp32 MUSIQ:

      embedding.{weight,bias}           [D, 3*P*P]
      cls_token                         [1, 1, D] (or [D])
      spatial_embedding                 [G*G, D] (or [G, G, D])
      scale_embedding                   [num_scales, D]
      transformer.{i}.norm1.{weight,bias}
      transformer.{i}.attn.qkv.{weight,bias}      (or .attn.{q,k,v}.* split)
      transformer.{i}.attn.proj.{weight,bias}
      transformer.{i}.norm2.{weight,bias}
      transformer.{i}.mlp.fc1.{weight,bias}
      transformer.{i}.mlp.fc2.{weight,bias}
      norm.{weight,bias}
      head.{weight,bias}

    Wrapper prefixes (``module.``, ``net.``, ``model.``) are stripped; an
    unmatched checkpoint key raises, naming the first twenty."""
    cfg = cfg or MUSIQConfig()
    sd = {k.split(".", 1)[1] if k.split(".", 1)[0] in ("module", "net", "model")
          else k: torch.as_tensor(np.asarray(v, np.float32)) for k, v in sd.items()}
    used: set[str] = set()
    out: dict[str, torch.Tensor] = {}

    def take(key):
        used.add(key)
        return sd[key]

    def lin(ours, theirs):
        out[f"{ours}.weight"] = take(f"{theirs}.weight")
        if f"{theirs}.bias" in sd:
            out[f"{ours}.bias"] = take(f"{theirs}.bias")

    def ln(ours, theirs):
        out[f"{ours}.weight"], out[f"{ours}.bias"] = (take(f"{theirs}.weight"),
                                                      take(f"{theirs}.bias"))

    for i in range(cfg.num_layers):
        pre, ours = f"transformer.{i}", f"blocks.{i}"
        ln(f"{ours}.norm1", f"{pre}.norm1")
        if f"{pre}.attn.qkv.weight" in sd:
            lin(f"{ours}.qkv", f"{pre}.attn.qkv")
        else:  # split q/k/v -> fused rows in q, k, v order
            out[f"{ours}.qkv.weight"] = torch.cat(
                [take(f"{pre}.attn.{n}.weight") for n in "qkv"])
            if f"{pre}.attn.q.bias" in sd:
                out[f"{ours}.qkv.bias"] = torch.cat(
                    [take(f"{pre}.attn.{n}.bias") for n in "qkv"])
        lin(f"{ours}.proj", f"{pre}.attn.proj")
        ln(f"{ours}.norm2", f"{pre}.norm2")
        lin(f"{ours}.fc1", f"{pre}.mlp.fc1")
        lin(f"{ours}.fc2", f"{pre}.mlp.fc2")
    lin("embedding", "embedding")
    lin("head", "head")
    ln("norm", "norm")
    out["cls_token"] = take("cls_token").reshape(1, 1, cfg.hidden)
    out["spatial_embedding"] = take("spatial_embedding").reshape(cfg.hse_grid ** 2,
                                                                 cfg.hidden)
    out["scale_embedding"] = take("scale_embedding").reshape(cfg.num_scales, cfg.hidden)
    unmatched = sorted(set(sd) - used)
    if unmatched:
        raise ValueError(
            f"MUSIQ converter: {len(unmatched)} unmatched checkpoint keys "
            f"(first 20): {unmatched[:20]} — adjust the key map in "
            f"dove_tpu_torch/eval/musiq.py:convert_state_dict"
        )
    model = MUSIQ(cfg)
    load_tensors(model, out)
    return _frozen(model, device)


def load_musiq(path: str, cfg: MUSIQConfig | None = None, device="cpu") -> MUSIQ:
    sd = torch.load(path, map_location="cpu", weights_only=True)
    if hasattr(sd, "state_dict"):
        sd = sd.state_dict()
    if "state_dict" in sd and isinstance(sd["state_dict"], dict):
        sd = sd["state_dict"]
    return convert_state_dict({k: v.numpy() for k, v in sd.items()},
                              cfg or MUSIQConfig(), device)


def musiq_metric(params_path: str | None = None, device=None):
    """Frame-averaged MUSIQ for [F, H, W, 3] clips in [0, 1], on the card
    unless ``device`` says otherwise; weights from DOVE_MUSIQ_WEIGHTS (or
    ``params_path``)."""
    from dove_tpu_torch.pipeline import resolve_device

    path = params_path or os.environ.get("DOVE_MUSIQ_WEIGHTS")
    if not path or not os.path.exists(path):
        raise NotImplementedError(
            "MUSIQ needs pretrained weights: set DOVE_MUSIQ_WEIGHTS to a "
            "locally exported state dict of the koniq-trained model (the "
            "reference obtains it via pyiqa's `musiq`; see "
            "dove_tpu_torch/eval/musiq.py:convert_state_dict for the layout)"
        )
    device = resolve_device(device)
    model = load_musiq(path, MUSIQConfig(), device)

    @torch.no_grad()
    def fn(pred: np.ndarray, _gt=None) -> float:
        # per-frame logits in fp32, averaged in float64 as the JAX package
        # averages its per-frame Python floats
        return float(np.mean(musiq_scores(model, pred, device).double().cpu().numpy()))

    return fn
