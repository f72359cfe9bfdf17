"""MANIQA (no-reference), in PyTorch.

Counterpart of ``dove_tpu/eval/maniqa.py``: the official IIGROUP/MANIQA
model (pyiqa's ``maniqa``). A ViT-B/8 whose block 6-9 token features are
concatenated and fused by transposed-attention blocks (TABlock: attention
over the channel axis, keeping the official ``(attn @ v).transpose(1, 2)
.reshape(B, C, N)`` memory reinterpretation), two small Swin stages with
relative-position bias and scaled stage residuals, and a patch-weighted
two-head scorer (score x sigmoid weight over the weight sum).

Scoring protocol (the official test protocol, as the JAX package runs it):
per call a fresh ``np.random.default_rng(0)``; per frame ``DOVE_MANIQA_CROPS``
(default 20) random 224x224 crops, drawn on the host in the same order, the
frame reflect-padded first where it is smaller than 224; the crops' scores
averaged per frame, the frames' averaged. Inputs normalised with mean = std
= 0.5. The crops of ``MANIQA_FRAMES`` frames go through the model at once,
in fp32 without TF32, on the card unless the caller passes ``device``.

Weights-gated: ``DOVE_MANIQA_WEIGHTS`` names the official checkpoint
(``ckpt_koniq10k.pt``), converted by :func:`convert_state_dict`.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any, Mapping

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from dove_tpu_torch.eval.clip import f32, load_tensors
from dove_tpu_torch.eval.musiq import Block

# frames whose crops share a forward (20 crops a frame)
MANIQA_FRAMES = 4


@dataclasses.dataclass(frozen=True)
class MANIQAConfig:
    img_size: int = 224
    patch_size: int = 8
    vit_width: int = 768
    vit_layers: int = 12
    vit_heads: int = 12
    vit_mlp: int = 3072
    feature_blocks: tuple = (6, 7, 8, 9)  # official extract_feature
    embed_dim: int = 768
    num_tab: int = 2
    depths: tuple = (2, 2)
    num_heads: tuple = (4, 4)
    window_size: int = 4
    dim_mlp: int = 768
    scale: float = 0.8  # koniq checkpoint's stage-residual blend
    eps: float = 1e-6

    @property
    def tokens(self) -> int:
        return (self.img_size // self.patch_size) ** 2


# --- the pieces ------------------------------------------------------------------

class TABlock(nn.Module):
    """Attention over channels: x [B, C, N], each channel a token."""

    def __init__(self, n: int):
        super().__init__()
        self.c_q, self.c_k, self.c_v = (nn.Linear(n, n) for _ in range(3))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, C, N = x.shape
        q, k, v = self.c_q(x), self.c_k(x), self.c_v(x)
        attn = torch.softmax((q @ k.transpose(1, 2)) * N ** -0.5, dim=-1)
        y = (attn @ v).transpose(1, 2).reshape(B, C, N)  # the official quirk
        return y + x


def relative_position_index(w: int) -> np.ndarray:
    """[w^2 * w^2] rows of the (2w-1)^2 bias table, Swin's order."""
    coords = np.stack(np.meshgrid(np.arange(w), np.arange(w), indexing="ij")).reshape(2, -1)
    rel = (coords[:, :, None] - coords[:, None, :]).transpose(1, 2, 0) + (w - 1)
    return (rel[..., 0] * (2 * w - 1) + rel[..., 1]).reshape(-1)


def window_partition(x: torch.Tensor, w: int) -> torch.Tensor:
    """[B, H, W, C] -> [B * nW, w * w, C]."""
    B, H, W, C = x.shape
    x = x.reshape(B, H // w, w, W // w, w, C)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(-1, w * w, C)


def window_reverse(x: torch.Tensor, w: int, B: int, H: int, W: int) -> torch.Tensor:
    C = x.shape[-1]
    x = x.reshape(B, H // w, W // w, w, w, C)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(B, H, W, C)


def shift_mask(H: int, W: int, w: int, shift: int) -> np.ndarray:
    """Swin's SW-MSA mask: [nW, w^2, w^2], -100 between regions, else 0."""
    img = np.zeros((H, W))
    cnt = 0
    for hs in (slice(0, -w), slice(-w, -shift), slice(-shift, None)):
        for ws in (slice(0, -w), slice(-w, -shift), slice(-shift, None)):
            img[hs, ws] = cnt
            cnt += 1
    win = img.reshape(H // w, w, W // w, w).transpose(0, 2, 1, 3).reshape(-1, w * w)
    diff = win[:, None, :] - win[:, :, None]
    return np.where(diff != 0, -100.0, 0.0)


class SwinBlock(nn.Module):
    def __init__(self, dim: int, heads: int, window: int, shift: int, mlp: int,
                 eps: float):
        super().__init__()
        self.heads, self.window, self.shift = heads, window, shift
        self.norm1 = nn.LayerNorm(dim, eps=eps)
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)
        self.rel_bias_table = nn.Parameter(torch.zeros((2 * window - 1) ** 2, heads))
        self.norm2 = nn.LayerNorm(dim, eps=eps)
        self.fc1 = nn.Linear(dim, mlp)
        self.fc2 = nn.Linear(mlp, dim)

    def forward(self, x: torch.Tensor, H: int, W: int) -> torch.Tensor:
        """x: [B, H*W, C]."""
        B, L, C = x.shape
        w, s, nh = self.window, self.shift, self.heads
        h = self.norm1(x).reshape(B, H, W, C)
        if s:
            h = torch.roll(h, (-s, -s), dims=(1, 2))
        wins = window_partition(h, w)
        qkv = self.qkv(wins).view(-1, w * w, 3, nh, C // nh).permute(2, 0, 3, 1, 4)
        q, k, v = qkv[0], qkv[1], qkv[2]
        logits = (q * (C // nh) ** -0.5) @ k.transpose(-1, -2)
        idx = torch.as_tensor(relative_position_index(w), device=x.device)
        bias = self.rel_bias_table[idx].view(w * w, w * w, nh).permute(2, 0, 1)
        logits = logits + bias[None]
        if s:
            mask = torch.as_tensor(shift_mask(H, W, w, s), dtype=logits.dtype,
                                   device=x.device)
            nW = mask.shape[0]
            logits = (logits.view(B, nW, nh, w * w, w * w) + mask[None, :, None]
                      ).view(-1, nh, w * w, w * w)
        o = torch.softmax(logits, dim=-1) @ v
        o = self.proj(o.transpose(1, 2).reshape(-1, w * w, C))
        h = window_reverse(o, w, B, H, W)
        if s:
            h = torch.roll(h, (s, s), dims=(1, 2))
        x = x + h.reshape(B, L, C)
        return x + self.fc2(F.gelu(self.fc1(self.norm2(x))))


class SwinStage(nn.Module):
    def __init__(self, cfg: MANIQAConfig, dim: int, mlp: int):
        super().__init__()
        self.scale = cfg.scale
        self.layers = nn.ModuleList(
            nn.ModuleList(SwinBlock(dim, cfg.num_heads[li], cfg.window_size,
                                    0 if bi % 2 == 0 else cfg.window_size // 2, mlp,
                                    cfg.eps)
                          for bi in range(depth))
            for li, depth in enumerate(cfg.depths))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """[B, C, H, W] -> the same; scaled stage residual."""
        B, C, H, W = x.shape
        h = x.permute(0, 2, 3, 1).reshape(B, H * W, C)
        for layer in self.layers:
            for blk in layer:
                h = blk(h, H, W)
        return self.scale * h.reshape(B, H, W, C).permute(0, 3, 1, 2) + x


class MANIQA(nn.Module):
    def __init__(self, cfg: MANIQAConfig, dim_mlp: int | None = None):
        super().__init__()
        self.cfg = cfg
        w, n, e = cfg.vit_width, cfg.tokens, cfg.embed_dim
        mlp = cfg.dim_mlp if dim_mlp is None else dim_mlp
        self.patch_embed = nn.Conv2d(3, w, cfg.patch_size, stride=cfg.patch_size)
        self.cls_token = nn.Parameter(torch.zeros(1, w))
        self.pos_embed = nn.Parameter(torch.zeros(n + 1, w))
        # the blocks up to the last whose features are taken
        self.blocks = nn.ModuleList(Block(w, cfg.vit_heads, cfg.vit_mlp, cfg.eps)
                                    for _ in range(max(cfg.feature_blocks) + 1))
        self.tablock1 = nn.ModuleList(TABlock(n) for _ in range(cfg.num_tab))
        self.conv1 = nn.Conv2d(w * len(cfg.feature_blocks), e, 1)
        self.swin1 = SwinStage(cfg, e, mlp)
        self.tablock2 = nn.ModuleList(TABlock(n) for _ in range(cfg.num_tab))
        self.conv2 = nn.Conv2d(e, e // 2, 1)
        self.swin2 = SwinStage(cfg, e // 2, mlp)
        self.fc_score = nn.ModuleList([nn.Linear(e // 2, e // 2), nn.Linear(e // 2, 1)])
        self.fc_weight = nn.ModuleList([nn.Linear(e // 2, e // 2), nn.Linear(e // 2, 1)])

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        """[B, 224, 224, 3] in [0, 1] -> scores [B] (higher is better)."""
        cfg = self.cfg
        x = (images.float() - 0.5) / 0.5
        x = self.patch_embed(x.permute(0, 3, 1, 2)).flatten(2).transpose(1, 2)
        B = x.shape[0]
        x = torch.cat([self.cls_token.expand(B, 1, -1), x], dim=1) + self.pos_embed
        feats = []
        for i, blk in enumerate(self.blocks):
            x = blk(x)
            if i in cfg.feature_blocks:
                feats.append(x[:, 1:])
        hw = cfg.img_size // cfg.patch_size
        x = torch.cat(feats, dim=-1).transpose(1, 2)  # [B, 4w, N]
        for tab in self.tablock1:
            x = tab(x)
        x = self.swin1(self.conv1(x.reshape(B, -1, hw, hw)))
        x = x.reshape(B, cfg.embed_dim, hw * hw)
        for tab in self.tablock2:
            x = tab(x)
        x = self.swin2(self.conv2(x.reshape(B, cfg.embed_dim, hw, hw)))
        x = x.reshape(B, cfg.embed_dim // 2, hw * hw).transpose(1, 2)
        score = F.relu(self.fc_score[1](F.relu(self.fc_score[0](x))))
        weight = torch.sigmoid(self.fc_weight[1](F.relu(self.fc_weight[0](x))))
        return (score * weight).sum((1, 2)) / torch.clamp(weight.sum((1, 2)), min=1e-8)


# --- parameters ---------------------------------------------------------------------

def from_jax_maniqa(params: Mapping[str, Any], cfg: MANIQAConfig, device="cpu") -> MANIQA:
    """The JAX package's tree (``convert_state_dict``'s, NumPy leaves, [in,
    out] weights, HWIO patch kernel) -> a frozen fp32 MANIQA."""
    out = {}

    def lin(name, p):
        out[f"{name}.weight"] = f32(p["weight"]).T
        if "bias" in p:
            out[f"{name}.bias"] = f32(p["bias"])

    def ln(name, p):
        out[f"{name}.weight"], out[f"{name}.bias"] = f32(p["weight"]), f32(p["bias"])

    v = params["vit"]
    out["patch_embed.weight"] = f32(v["patch_kernel"]).permute(3, 2, 0, 1)
    out["patch_embed.bias"] = f32(v["patch_bias"])
    out["cls_token"] = f32(v["cls_token"])
    out["pos_embed"] = f32(v["pos_embed"])
    for i in range(max(cfg.feature_blocks) + 1):
        blk = v["blocks"][i]
        for name in ("qkv", "proj", "fc1", "fc2"):
            lin(f"blocks.{i}.{name}", blk[name])
        for name in ("norm1", "norm2"):
            ln(f"blocks.{i}.{name}", blk[name])
    for t in ("tablock1", "tablock2"):
        for i, tab in enumerate(params[t]):
            for name in ("c_q", "c_k", "c_v"):
                lin(f"{t}.{i}.{name}", tab[name])
    for name in ("conv1", "conv2"):  # [in, out] -> [out, in, 1, 1]
        out[f"{name}.weight"] = f32(params[name]["weight"]).T[:, :, None, None]
        out[f"{name}.bias"] = f32(params[name]["bias"])
    for stage in ("swin1", "swin2"):
        for li, layer in enumerate(params[stage]["layers"]):
            for bi, blk in enumerate(layer):
                pre = f"{stage}.layers.{li}.{bi}"
                for name in ("qkv", "proj", "fc1", "fc2"):
                    lin(f"{pre}.{name}", blk[name])
                for name in ("norm1", "norm2"):
                    ln(f"{pre}.{name}", blk[name])
                out[f"{pre}.rel_bias_table"] = f32(blk["rel_bias_table"])
    for head in ("fc_score", "fc_weight"):
        for j, p in enumerate(params[head]):
            lin(f"{head}.{j}", p)
    dim_mlp = out["swin1.layers.0.0.fc1.weight"].shape[0]
    model = MANIQA(cfg, dim_mlp)
    load_tensors(model, out)
    return model.eval().requires_grad_(False).to(device)


def convert_state_dict(sd: Mapping[str, Any], cfg: MANIQAConfig, device="cpu") -> MANIQA:
    """The official MANIQA state dict -> a frozen fp32 MANIQA. The ViT's
    blocks past the last feature block and its other extras are not read;
    any other key it does not understand raises."""
    sd = {k: torch.as_tensor(np.asarray(v, np.float32)) for k, v in sd.items()}
    used: set[str] = set()
    out: dict[str, torch.Tensor] = {}

    def take(key):
        used.add(key)
        return sd[key]

    def copy(ours, theirs, leaves=("weight", "bias")):
        for leaf in leaves:
            if f"{theirs}.{leaf}" in sd:
                out[f"{ours}.{leaf}"] = take(f"{theirs}.{leaf}")

    out["cls_token"] = take("vit.cls_token")[0]
    out["pos_embed"] = take("vit.pos_embed")[0]
    copy("patch_embed", "vit.patch_embed.proj")
    for i in range(max(cfg.feature_blocks) + 1):
        for ours, theirs in (("norm1", "norm1"), ("qkv", "attn.qkv"), ("proj", "attn.proj"),
                             ("norm2", "norm2"), ("fc1", "mlp.fc1"), ("fc2", "mlp.fc2")):
            copy(f"blocks.{i}.{ours}", f"vit.blocks.{i}.{theirs}")
    n_tab = 0
    for t in ("tablock1", "tablock2"):
        i = 0
        while f"{t}.{i}.c_q.weight" in sd:
            for name in ("c_q", "c_k", "c_v"):
                copy(f"{t}.{i}.{name}", f"{t}.{i}.{name}")
            i += 1
        n_tab = i
    copy("conv1", "conv1")
    copy("conv2", "conv2")
    depths = []
    for stage, theirs in (("swin1", "swintransformer1"), ("swin2", "swintransformer2")):
        depths = []
        while f"{theirs}.layers.{len(depths)}.blocks.0.norm1.weight" in sd:
            li, bi = len(depths), 0
            while f"{theirs}.layers.{li}.blocks.{bi}.norm1.weight" in sd:
                b, ours = f"{theirs}.layers.{li}.blocks.{bi}", f"{stage}.layers.{li}.{bi}"
                used.add(f"{b}.attn.relative_position_index")  # recomputed
                for o, th in (("norm1", "norm1"), ("qkv", "attn.qkv"),
                              ("proj", "attn.proj"), ("norm2", "norm2"),
                              ("fc1", "mlp.fc1"), ("fc2", "mlp.fc2")):
                    copy(f"{ours}.{o}", f"{b}.{th}")
                out[f"{ours}.rel_bias_table"] = take(f"{b}.attn.relative_position_bias_table")
                bi += 1
            depths.append(bi)
    # Sequential indices: 0 Linear, (1 ReLU, 2 Dropout,) 3 Linear
    for head in ("fc_score", "fc_weight"):
        copy(f"{head}.0", f"{head}.0")
        copy(f"{head}.1", f"{head}.3")
    unmatched = {k for k in sd if k not in used and not k.startswith("vit.")
                 and "relative_position_index" not in k}
    if unmatched:
        raise ValueError(
            f"MANIQA checkpoint keys not understood: {sorted(unmatched)[:10]}"
            f" (+{max(len(unmatched) - 10, 0)} more) — layout drift from the"
            " official IIGROUP/MANIQA module?"
        )
    cfg = dataclasses.replace(cfg, num_tab=n_tab, depths=tuple(depths))
    model = MANIQA(cfg, out["swin1.layers.0.0.fc1.weight"].shape[0])
    load_tensors(model, out)
    return model.eval().requires_grad_(False).to(device)


def load_maniqa(path: str, cfg: MANIQAConfig | None = None, device="cpu") -> MANIQA:
    cfg = cfg or MANIQAConfig()
    # the JAX package's load: a full pickle (the official checkpoint is one)
    sd = torch.load(path, map_location="cpu", weights_only=False)
    for key in ("state_dict", "model", "model_state_dict"):
        if isinstance(sd, dict) and key in sd and isinstance(sd[key], dict):
            sd = sd[key]
    sd = {k.removeprefix("module."): v.numpy() for k, v in sd.items()}
    return convert_state_dict(sd, cfg, device)


def crop_origins(shapes: list[tuple[int, int]], size: int, n_crops: int):
    """The protocol's draws for frames of the given (H, W) (after padding),
    from one ``np.random.default_rng(0)``: per frame (ys [n], xs [n])."""
    rng = np.random.default_rng(0)
    return [(rng.integers(0, H - size + 1, n_crops), rng.integers(0, W - size + 1, n_crops))
            for H, W in shapes]


def maniqa_scores(model: MANIQA, frames: np.ndarray, n_crops: int, device) -> list[float]:
    """[F, H, W, 3] in [0, 1] -> each frame's mean crop score."""
    from dove_tpu_torch.eval.vgg import full_fp32

    s = model.cfg.img_size
    H, W = frames.shape[1:3]
    if H < s or W < s:
        pad = ((0, 0), (0, max(s - H, 0)), (0, max(s - W, 0)), (0, 0))
        frames = np.stack([np.pad(f, pad[1:], mode="reflect") for f in frames])
    origins = crop_origins([frames.shape[1:3]] * len(frames), s, n_crops)
    out = []
    with full_fp32():
        for f0 in range(0, len(frames), MANIQA_FRAMES):
            x = torch.as_tensor(np.asarray(frames[f0:f0 + MANIQA_FRAMES], np.float32),
                                device=device)
            crops = torch.stack([x[j, y:y + s, xx:xx + s]
                                 for j, (ys, xs) in enumerate(origins[f0:f0 + len(x)])
                                 for y, xx in zip(ys, xs)])
            out += model(crops).view(len(x), n_crops).mean(1).tolist()
    return out


def maniqa_metric(params_path: str | None = None, device=None):
    """-> fn(pred [F, H, W, 3] float [0, 1]) -> the mean MANIQA score, on the
    card unless ``device`` says otherwise."""
    from dove_tpu_torch.pipeline import resolve_device

    path = params_path or os.environ.get("DOVE_MANIQA_WEIGHTS")
    if not path or not os.path.exists(path):
        raise NotImplementedError(
            "MANIQA needs the official pretrained checkpoint: set "
            "DOVE_MANIQA_WEIGHTS to a local ckpt_koniq10k.pt "
            "(IIGROUP/MANIQA; no downloads available here)"
        )
    device = resolve_device(device)
    model = load_maniqa(path, device=device)
    n_crops = int(os.environ.get("DOVE_MANIQA_CROPS", "20"))

    @torch.no_grad()
    def fn(pred: np.ndarray, _gt=None) -> float:
        return float(np.mean(maniqa_scores(model, np.asarray(pred), n_crops, device)))

    return fn
