"""CLIP towers (ViT-B/32 and RN50) and the CLIP-IQA metric in PyTorch.

Counterpart of ``dove_tpu/eval/clip.py``. CLIP-IQA scores a frame by its
antonym prompts,

    s = softmax([sim(img, "Good photo."), sim(img, "Bad photo.")])[good],

averaged over the frames. The checkpoint picks the backbone:

  * ``DOVE_CLIP_WEIGHTS`` a directory: a HuggingFace ``CLIPModel`` snapshot
    (openai/clip-vit-base-patch32): the ViT tower at 224x224, each frame
    resized there by ``ops/resize.py``'s ``cubic`` (OpenCV's INTER_CUBIC,
    which the JAX package calls), clamped to [0, 1] and normalised;
  * ``DOVE_CLIP_WEIGHTS`` a file: an OpenAI CLIP RN50 state dict (``.pt``),
    pyiqa's clipiqa default: the modified ResNet-50 (anti-aliased strides,
    attention pool) at the frame's own size, the attention pool's positional
    embedding dropped; the tokenizer files sit beside it or in
    ``DOVE_CLIP_TOKENIZER``.

The prompts go through ``eval/clip_tokenizer.py``, which reads the
checkpoint's ``vocab.json`` and ``merges.txt`` (no ``transformers``). The
towers run in fp32 without TF32, on the card unless the caller passes
``device``; frames go through in slices of ``CLIP_FRAMES``. Modules keep the
torch layouts of the published checkpoints (Linear [out, in], conv OIHW),
and take images as [B, H, W, 3] like the JAX package.
"""

from __future__ import annotations

import dataclasses
import json
import os
from pathlib import Path
from typing import Any, Mapping

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

_MEAN = (0.48145466, 0.4578275, 0.40821073)
_STD = (0.26862954, 0.26130258, 0.27577711)

GOOD_PROMPT = "Good photo."
BAD_PROMPT = "Bad photo."

RN50_LAYERS = (3, 4, 6, 3)

# frames per tower pass of the metric (the RN50 tower runs at the frame's
# own size: a 720p frame's first stage is ~0.9 GB of fp32 activations)
CLIP_FRAMES = 8


@dataclasses.dataclass(frozen=True)
class CLIPConfig:
    # vision (ViT-B/32 defaults)
    image_size: int = 224
    patch_size: int = 32
    vision_width: int = 768
    vision_layers: int = 12
    vision_heads: int = 12
    # text
    vocab_size: int = 49408
    context_length: int = 77
    text_width: int = 512
    text_layers: int = 12
    text_heads: int = 8
    # joint
    projection_dim: int = 512
    layer_norm_eps: float = 1e-5


# ---------------------------------------------------------------------------
# Transformer towers
# ---------------------------------------------------------------------------

def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              causal: bool = False) -> torch.Tensor:
    """softmax((q * d^-0.5) k^T) v on [..., S, d] with the JAX package's
    order of operations (q scaled before the product); ``causal`` sets the
    logits above the diagonal to -1e9."""
    logits = (q * q.shape[-1] ** -0.5) @ k.transpose(-1, -2)
    if causal:
        S = logits.shape[-1]
        upper = torch.ones(S, S, dtype=torch.bool, device=q.device).triu_(1)
        logits = logits.masked_fill(upper, -1e9)
    return torch.softmax(logits, dim=-1) @ v


class Block(nn.Module):
    """Pre-LN transformer block: multi-head attention, quick-GELU MLP."""

    def __init__(self, width: int, heads: int, eps: float):
        super().__init__()
        self.heads = heads
        self.ln1 = nn.LayerNorm(width, eps=eps)
        self.q, self.k, self.v, self.out = (nn.Linear(width, width) for _ in range(4))
        self.ln2 = nn.LayerNorm(width, eps=eps)
        self.fc1 = nn.Linear(width, 4 * width)
        self.fc2 = nn.Linear(4 * width, width)

    def forward(self, x: torch.Tensor, causal: bool = False) -> torch.Tensor:
        B, S, D = x.shape
        h = self.ln1(x)

        def heads(lin):
            return lin(h).view(B, S, self.heads, -1).transpose(1, 2)

        o = attention(heads(self.q), heads(self.k), heads(self.v), causal)
        x = x + self.out(o.transpose(1, 2).reshape(B, S, D))
        h = self.fc1(self.ln2(x))
        return x + self.fc2(h * torch.sigmoid(1.702 * h))


class VisionViT(nn.Module):
    def __init__(self, cfg: CLIPConfig):
        super().__init__()
        w = cfg.vision_width
        self.patch_embed = nn.Conv2d(3, w, cfg.patch_size, stride=cfg.patch_size,
                                     bias=False)
        self.class_embed = nn.Parameter(torch.zeros(w))
        self.pos_embed = nn.Parameter(
            torch.zeros((cfg.image_size // cfg.patch_size) ** 2 + 1, w))
        self.pre_ln = nn.LayerNorm(w, eps=cfg.layer_norm_eps)
        self.blocks = nn.ModuleList(Block(w, cfg.vision_heads, cfg.layer_norm_eps)
                                    for _ in range(cfg.vision_layers))
        self.post_ln = nn.LayerNorm(w, eps=cfg.layer_norm_eps)

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        """[B, 224, 224, 3] normalised -> the pooled [B, width]."""
        x = self.patch_embed(images.permute(0, 3, 1, 2)).flatten(2).transpose(1, 2)
        cls = self.class_embed.expand(x.shape[0], 1, -1)
        x = self.pre_ln(torch.cat([cls, x], dim=1) + self.pos_embed)
        for blk in self.blocks:
            x = blk(x)
        return self.post_ln(x[:, 0])


class TextTower(nn.Module):
    def __init__(self, cfg: CLIPConfig):
        super().__init__()
        self.token_embed = nn.Embedding(cfg.vocab_size, cfg.text_width)
        self.pos_embed = nn.Parameter(torch.zeros(cfg.context_length, cfg.text_width))
        self.blocks = nn.ModuleList(Block(cfg.text_width, cfg.text_heads,
                                          cfg.layer_norm_eps)
                                    for _ in range(cfg.text_layers))
        self.final_ln = nn.LayerNorm(cfg.text_width, eps=cfg.layer_norm_eps)

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        """[B, S] ids -> [B, width] at the end token (the highest id)."""
        x = self.token_embed(ids) + self.pos_embed[: ids.shape[1]]
        for blk in self.blocks:
            x = blk(x, causal=True)
        x = self.final_ln(x)
        return x[torch.arange(x.shape[0], device=x.device), ids.argmax(dim=-1)]


# ---------------------------------------------------------------------------
# Modified ResNet-50 (OpenAI CLIP "RN50"), BatchNorms folded to scale/bias
# ---------------------------------------------------------------------------

class FoldedBN(nn.Module):
    """Inference BatchNorm as x * scale + bias, per channel (NCHW)."""

    def __init__(self, c: int):
        super().__init__()
        self.register_buffer("scale", torch.ones(c))
        self.register_buffer("bias", torch.zeros(c))

    def forward(self, x):
        return x * self.scale.view(-1, 1, 1) + self.bias.view(-1, 1, 1)


def _conv(cin, cout, k):
    return nn.Conv2d(cin, cout, k, padding=k // 2, bias=False)


class Bottleneck(nn.Module):
    def __init__(self, cin: int, planes: int, stride: int, downsample: bool):
        super().__init__()
        self.stride = stride
        self.conv1, self.bn1 = _conv(cin, planes, 1), FoldedBN(planes)
        self.conv2, self.bn2 = _conv(planes, planes, 3), FoldedBN(planes)
        self.conv3, self.bn3 = _conv(planes, 4 * planes, 1), FoldedBN(4 * planes)
        self.down_conv = _conv(cin, 4 * planes, 1) if downsample else None
        self.down_bn = FoldedBN(4 * planes) if downsample else None

    def forward(self, x):
        h = F.relu(self.bn1(self.conv1(x)))
        h = F.relu(self.bn2(self.conv2(h)))
        if self.stride > 1:
            h = F.avg_pool2d(h, self.stride)
        h = self.bn3(self.conv3(h))
        if self.down_conv is not None:
            x = F.avg_pool2d(x, self.stride) if self.stride > 1 else x
            x = self.down_bn(self.down_conv(x))
        return F.relu(x + h)


class VisionRN50(nn.Module):
    def __init__(self, width: int = 64, heads: int = 32, out_dim: int = 1024,
                 layers=RN50_LAYERS):
        super().__init__()
        self.heads = heads
        self.conv1 = nn.Conv2d(3, width // 2, 3, stride=2, padding=1, bias=False)
        self.bn1 = FoldedBN(width // 2)
        self.conv2, self.bn2 = _conv(width // 2, width // 2, 3), FoldedBN(width // 2)
        self.conv3, self.bn3 = _conv(width // 2, width, 3), FoldedBN(width)
        stages, cin = [], width
        for li, n in enumerate(layers):
            planes = width * 2 ** li
            stages.append(nn.ModuleList(
                Bottleneck(cin if bi == 0 else 4 * planes, planes,
                           2 if (li > 0 and bi == 0) else 1, bi == 0)
                for bi in range(n)))
            cin = 4 * planes
        self.layers = nn.ModuleList(stages)
        self.q, self.k, self.v = (nn.Linear(cin, cin) for _ in range(3))
        self.c = nn.Linear(cin, out_dim)

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        """[B, H, W, 3] normalised, any size -> [B, out_dim], unnormalised."""
        x = images.permute(0, 3, 1, 2)
        x = F.relu(self.bn1(self.conv1(x)))
        x = F.relu(self.bn2(self.conv2(x)))
        x = F.relu(self.bn3(self.conv3(x)))
        x = F.avg_pool2d(x, 2)
        for stage in self.layers:
            for blk in stage:
                x = blk(x)
        # attention pool, the positional embedding dropped (CLIP-IQA)
        B, C = x.shape[:2]
        tokens = x.flatten(2).transpose(1, 2)
        tokens = torch.cat([tokens.mean(1, keepdim=True), tokens], dim=1)

        def heads(t):
            return t.view(B, t.shape[1], self.heads, -1).transpose(1, 2)

        o = attention(heads(self.q(tokens[:, :1])), heads(self.k(tokens)),
                      heads(self.v(tokens)))
        return self.c(o.transpose(1, 2).reshape(B, C))


class CLIP(nn.Module):
    """A vision tower (``VisionViT`` or ``VisionRN50``) and the text tower,
    with their projections (the RN50's is its attention pool's)."""

    def __init__(self, cfg: CLIPConfig, vision: nn.Module | None = None):
        super().__init__()
        self.cfg = cfg
        self.rn50 = isinstance(vision, VisionRN50)
        self.vision = VisionViT(cfg) if vision is None else vision
        self.text = TextTower(cfg)
        self.visual_projection = (None if self.rn50 else
                                  nn.Linear(cfg.vision_width, cfg.projection_dim,
                                            bias=False))
        self.text_projection = nn.Linear(cfg.text_width, cfg.projection_dim, bias=False)
        self.register_buffer("logit_scale", torch.tensor(float(np.log(100.0))))

    def encode_image(self, images: torch.Tensor) -> torch.Tensor:
        x = self.vision(images)
        if self.visual_projection is not None:
            x = self.visual_projection(x)
        return x / torch.linalg.vector_norm(x, dim=-1, keepdim=True)

    def encode_text(self, ids: torch.Tensor) -> torch.Tensor:
        x = self.text_projection(self.text(ids))
        return x / torch.linalg.vector_norm(x, dim=-1, keepdim=True)


def _frozen(module: nn.Module) -> nn.Module:
    return module.eval().requires_grad_(False)


# ---------------------------------------------------------------------------
# Parameters: from the JAX package's trees, and from the published files
# ---------------------------------------------------------------------------

def f32(a) -> torch.Tensor:
    return torch.tensor(np.asarray(a, np.float32))


def load_tensors(module: nn.Module, tensors: Mapping[str, torch.Tensor]) -> None:
    """Copy every named tensor in; a missing or unknown name raises."""
    own = dict(module.state_dict())
    missing, unknown = set(own) - set(tensors), set(tensors) - set(own)
    if missing or unknown:
        raise KeyError(f"CLIP parameters: missing {sorted(missing)[:8]}, "
                       f"unknown {sorted(unknown)[:8]}")
    with torch.no_grad():
        for name, t in tensors.items():
            if own[name].shape != t.shape:
                raise ValueError(f"{name}: {tuple(t.shape)}, want {tuple(own[name].shape)}")
            own[name].copy_(t)


def _jax_block(p: Mapping[str, Any], prefix: str, out: dict) -> None:
    def lin(name, leaf):
        out[f"{prefix}.{name}.weight"] = f32(leaf["kernel"]).T
        out[f"{prefix}.{name}.bias"] = f32(leaf["bias"])

    for name in ("ln1", "ln2"):
        out[f"{prefix}.{name}.weight"] = f32(p[name]["scale"])
        out[f"{prefix}.{name}.bias"] = f32(p[name]["bias"])
    for name in ("q", "k", "v", "out"):
        lin(name, p["attn"][name])
    lin("fc1", p["fc1"])
    lin("fc2", p["fc2"])


def _jax_text(t: Mapping[str, Any], out: dict) -> None:
    out["text.token_embed.weight"] = f32(t["token_embed"])
    out["text.pos_embed"] = f32(t["pos_embed"])
    for i, blk in enumerate(t["blocks"]):
        _jax_block(blk, f"text.blocks.{i}", out)
    out["text.final_ln.weight"] = f32(t["final_ln"]["scale"])
    out["text.final_ln.bias"] = f32(t["final_ln"]["bias"])


def from_jax_clip(params: Mapping[str, Any], cfg: CLIPConfig, device="cpu") -> CLIP:
    """``init_clip_params`` / ``load_clip``'s tree (NumPy leaves) -> a frozen
    fp32 ViT CLIP."""
    v = params["vision"]
    out = {
        "vision.patch_embed.weight": f32(v["patch_embed"]["kernel"]).permute(3, 2, 0, 1),
        "vision.class_embed": f32(v["class_embed"]),
        "vision.pos_embed": f32(v["pos_embed"]),
        "visual_projection.weight": f32(params["visual_projection"]).T,
        "text_projection.weight": f32(params["text_projection"]).T,
        "logit_scale": f32(params["logit_scale"]).reshape(()),
    }
    for name in ("pre_ln", "post_ln"):
        out[f"vision.{name}.weight"] = f32(v[name]["scale"])
        out[f"vision.{name}.bias"] = f32(v[name]["bias"])
    for i, blk in enumerate(v["blocks"]):
        _jax_block(blk, f"vision.blocks.{i}", out)
    _jax_text(params["text"], out)
    model = CLIP(cfg)
    load_tensors(model, out)
    return _frozen(model).to(device)


def from_jax_clip_rn50(params: Mapping[str, Any], cfg: CLIPConfig,
                       device="cpu") -> CLIP:
    """``init_clip_rn50_params``' vision tree beside ``init_clip_params``'
    text tree, or ``load_clip_rn50``'s tree (NumPy leaves) -> a frozen fp32
    RN50 CLIP."""
    v = params["vision"]
    ap = v["attnpool"]

    def conv(k):  # HWIO -> OIHW
        return f32(k).permute(3, 2, 0, 1)

    out = {}

    def bn(prefix, p):
        out[f"{prefix}.scale"] = f32(p["scale"])
        out[f"{prefix}.bias"] = f32(p["bias"])

    for i in (1, 2, 3):
        out[f"vision.conv{i}.weight"] = conv(v[f"conv{i}"])
        bn(f"vision.bn{i}", v[f"bn{i}"])
    for li, blocks in enumerate(v["layers"]):
        for bi, blk in enumerate(blocks):
            pre = f"vision.layers.{li}.{bi}"
            for i in (1, 2, 3):
                out[f"{pre}.conv{i}.weight"] = conv(blk[f"conv{i}"])
                bn(f"{pre}.bn{i}", blk[f"bn{i}"])
            if "downsample" in blk:
                out[f"{pre}.down_conv.weight"] = conv(blk["downsample"]["conv"])
                bn(f"{pre}.down_bn", blk["downsample"]["bn"])
    for name in ("q", "k", "v", "c"):
        out[f"vision.{name}.weight"] = f32(ap[name]["kernel"]).T
        out[f"vision.{name}.bias"] = f32(ap[name]["bias"])
    out["text_projection.weight"] = f32(params["text_projection"]).T
    out["logit_scale"] = f32(params["logit_scale"]).reshape(())
    _jax_text(params["text"], out)
    width = out["vision.conv3.weight"].shape[0]
    vision = VisionRN50(width, int(ap["num_heads"]), out["vision.c.weight"].shape[0],
                        tuple(len(b) for b in v["layers"]))
    model = CLIP(cfg, vision)
    load_tensors(model, out)
    return _frozen(model).to(device)


def _hf_config(model_dir: Path) -> CLIPConfig:
    raw = {}
    if (model_dir / "config.json").exists():
        raw = json.loads((model_dir / "config.json").read_text())
    vc, tc = raw.get("vision_config", {}), raw.get("text_config", {})
    return CLIPConfig(
        image_size=vc.get("image_size", 224),
        patch_size=vc.get("patch_size", 32),
        vision_width=vc.get("hidden_size", 768),
        vision_layers=vc.get("num_hidden_layers", 12),
        vision_heads=vc.get("num_attention_heads", 12),
        vocab_size=tc.get("vocab_size", 49408),
        context_length=tc.get("max_position_embeddings", 77),
        text_width=tc.get("hidden_size", 512),
        text_layers=tc.get("num_hidden_layers", 12),
        text_heads=tc.get("num_attention_heads", 8),
        projection_dim=raw.get("projection_dim", 512),
    )


def load_clip(model_dir: str | Path, device="cpu") -> CLIP:
    """A HuggingFace ``CLIPModel`` snapshot directory (config.json and
    ``*.safetensors`` or ``*.bin`` weights) -> a frozen fp32 ViT CLIP."""
    from dove_tpu_torch.eval.vgg import _read_state_dict

    model_dir = Path(model_dir)
    cfg = _hf_config(model_dir)
    files = sorted(model_dir.glob("*.safetensors")) or sorted(model_dir.glob("*.bin"))
    if not files:
        raise FileNotFoundError(f"no weight files in {model_dir}")
    sd: dict[str, torch.Tensor] = {}
    for f in files:
        sd.update(_read_state_dict(f))
    sd = {k: v.float() for k, v in sd.items()}
    vis, txt = "vision_model", "text_model"
    pre_ln = f"{vis}.pre_layrnorm" if f"{vis}.pre_layrnorm.weight" in sd else f"{vis}.pre_layernorm"
    out = {
        "vision.patch_embed.weight": sd[f"{vis}.embeddings.patch_embedding.weight"],
        "vision.class_embed": sd[f"{vis}.embeddings.class_embedding"],
        "vision.pos_embed": sd[f"{vis}.embeddings.position_embedding.weight"],
        "text.token_embed.weight": sd[f"{txt}.embeddings.token_embedding.weight"],
        "text.pos_embed": sd[f"{txt}.embeddings.position_embedding.weight"],
        "visual_projection.weight": sd["visual_projection.weight"],
        "text_projection.weight": sd["text_projection.weight"],
        "logit_scale": sd.get("logit_scale", torch.tensor(float(np.log(100.0)))).reshape(()),
    }
    for ours, theirs in (("vision.pre_ln", pre_ln), ("vision.post_ln", f"{vis}.post_layernorm"),
                         ("text.final_ln", f"{txt}.final_layer_norm")):
        out[f"{ours}.weight"] = sd[f"{theirs}.weight"]
        out[f"{ours}.bias"] = sd[f"{theirs}.bias"]
    hf = {"ln1": "layer_norm1", "ln2": "layer_norm2", "q": "self_attn.q_proj",
          "k": "self_attn.k_proj", "v": "self_attn.v_proj", "out": "self_attn.out_proj",
          "fc1": "mlp.fc1", "fc2": "mlp.fc2"}
    for tower, src, n in (("vision", vis, cfg.vision_layers), ("text", txt, cfg.text_layers)):
        for i in range(n):
            for ours, theirs in hf.items():
                for leaf in ("weight", "bias"):
                    out[f"{tower}.blocks.{i}.{ours}.{leaf}"] = \
                        sd[f"{src}.encoder.layers.{i}.{theirs}.{leaf}"]
    model = CLIP(cfg)
    load_tensors(model, out)
    return _frozen(model).to(device)


def _fold_bn(sd: Mapping[str, torch.Tensor], prefix: str, eps: float = 1e-5):
    """BatchNorm's four tensors -> (scale, bias), in NumPy float32 as the
    JAX package folds them."""
    w, b, mean, var = (np.asarray(sd[f"{prefix}.{n}"], np.float32)
                       for n in ("weight", "bias", "running_mean", "running_var"))
    scale = w / np.sqrt(var + eps)
    return torch.from_numpy(scale), torch.from_numpy(b - mean * scale)


def load_clip_rn50(path: str | Path, device="cpu") -> CLIP:
    """An OpenAI CLIP RN50 state dict (``clip.load('RN50')``'s, saved with
    torch.save) -> a frozen fp32 RN50 CLIP; the text tower's config is read
    off the tensors as the JAX package reads it."""
    sd = torch.load(str(path), map_location="cpu", weights_only=False)
    if hasattr(sd, "state_dict"):
        sd = sd.state_dict()
    sd = {k: (v.float() if torch.is_tensor(v) else torch.as_tensor(v)) for k, v in sd.items()}
    text_width = sd["ln_final.weight"].shape[0]
    n_text = len({k.split(".")[2] for k in sd if k.startswith("transformer.resblocks.")})
    embed_dim, attn_dim = sd["visual.attnpool.c_proj.weight"].shape
    cfg = CLIPConfig(vocab_size=sd["token_embedding.weight"].shape[0],
                     context_length=sd["positional_embedding"].shape[0],
                     text_width=text_width, text_layers=n_text,
                     text_heads=text_width // 64, projection_dim=embed_dim)
    out: dict[str, torch.Tensor] = {}

    def bn(ours, theirs):
        out[f"{ours}.scale"], out[f"{ours}.bias"] = _fold_bn(sd, theirs)

    for i in (1, 2, 3):
        out[f"vision.conv{i}.weight"] = sd[f"visual.conv{i}.weight"]
        bn(f"vision.bn{i}", f"visual.bn{i}")
    for li, n in enumerate(RN50_LAYERS):
        for bi in range(n):
            ours, theirs = f"vision.layers.{li}.{bi}", f"visual.layer{li + 1}.{bi}"
            for i in (1, 2, 3):
                out[f"{ours}.conv{i}.weight"] = sd[f"{theirs}.conv{i}.weight"]
                bn(f"{ours}.bn{i}", f"{theirs}.bn{i}")
            if f"{theirs}.downsample.0.weight" in sd:
                out[f"{ours}.down_conv.weight"] = sd[f"{theirs}.downsample.0.weight"]
                bn(f"{ours}.down_bn", f"{theirs}.downsample.1")
    for name in ("q", "k", "v", "c"):
        for leaf in ("weight", "bias"):
            out[f"vision.{name}.{leaf}"] = sd[f"visual.attnpool.{name}_proj.{leaf}"]
    out["text.token_embed.weight"] = sd["token_embedding.weight"]
    out["text.pos_embed"] = sd["positional_embedding"]
    out["text.final_ln.weight"] = sd["ln_final.weight"]
    out["text.final_ln.bias"] = sd["ln_final.bias"]
    for i in range(n_text):
        pre = f"transformer.resblocks.{i}"
        qkv_w = sd[f"{pre}.attn.in_proj_weight"].chunk(3)
        qkv_b = sd[f"{pre}.attn.in_proj_bias"].chunk(3)
        for j, name in enumerate("qkv"):
            out[f"text.blocks.{i}.{name}.weight"] = qkv_w[j]
            out[f"text.blocks.{i}.{name}.bias"] = qkv_b[j]
        for ours, theirs in (("ln1", "ln_1"), ("ln2", "ln_2"), ("out", "attn.out_proj"),
                             ("fc1", "mlp.c_fc"), ("fc2", "mlp.c_proj")):
            for leaf in ("weight", "bias"):
                out[f"text.blocks.{i}.{ours}.{leaf}"] = sd[f"{pre}.{theirs}.{leaf}"]
    # OpenAI stores text_projection as x @ W: our Linear takes W^T
    out["text_projection.weight"] = sd["text_projection"].T
    out["logit_scale"] = sd["logit_scale"].reshape(())
    width = out["vision.conv3.weight"].shape[0]
    model = CLIP(cfg, VisionRN50(width, attn_dim // 64, embed_dim))
    load_tensors(model, out)
    return _frozen(model).to(device)


# ---------------------------------------------------------------------------
# CLIP-IQA
# ---------------------------------------------------------------------------

def clipiqa_scores(model: CLIP, text_feats: torch.Tensor, frames: np.ndarray,
                   device) -> torch.Tensor:
    """[F, H, W, 3] in [0, 1] -> the per-frame scores [F] (fp32, on
    ``device``), ``CLIP_FRAMES`` frames a pass."""
    from dove_tpu_torch.eval.vgg import full_fp32
    from dove_tpu_torch.ops.resize import resize

    mean = torch.tensor(_MEAN, device=device)
    std = torch.tensor(_STD, device=device)
    scores = []
    with full_fp32():
        for s in range(0, len(frames), CLIP_FRAMES):
            x = torch.as_tensor(np.asarray(frames[s:s + CLIP_FRAMES], np.float32),
                                device=device)
            if not model.rn50:
                size = model.cfg.image_size
                x = resize(x, (size, size), "cubic")
            x = (x.clamp(0, 1) - mean) / std
            logits = model.logit_scale.exp() * model.encode_image(x) @ text_feats.T
            scores.append(torch.softmax(logits, dim=-1)[:, 0])
    return torch.cat(scores)


def clipiqa_metric(model_dir: str | Path | None = None, device=None):
    """The CLIP-IQA callable: [F, H, W, 3] in [0, 1] -> the mean score.

    ``model_dir`` defaults to $DOVE_CLIP_WEIGHTS: a directory is a HF
    CLIPModel snapshot (ViT), a file an OpenAI RN50 state dict. Raises the
    JAX package's error when there is none (no downloads). Runs on the card
    unless ``device`` says otherwise."""
    from dove_tpu_torch.eval.clip_tokenizer import CLIPTokenizer
    from dove_tpu_torch.eval.vgg import full_fp32
    from dove_tpu_torch.pipeline import resolve_device

    model_dir = model_dir or os.environ.get("DOVE_CLIP_WEIGHTS")
    if not model_dir or not Path(model_dir).exists():
        raise NotImplementedError(
            "clipiqa needs a local CLIP checkpoint: set DOVE_CLIP_WEIGHTS to "
            "a HF clip-vit-base-patch32 snapshot directory (config.json + "
            "model weights + tokenizer files) or an OpenAI CLIP RN50 state "
            "dict .pt (pyiqa-default backbone; tokenizer files alongside or "
            "in DOVE_CLIP_TOKENIZER)"
        )
    device = resolve_device(device)
    if Path(model_dir).is_file():
        model = load_clip_rn50(model_dir, device)
        tok_dir = os.environ.get("DOVE_CLIP_TOKENIZER", str(Path(model_dir).parent))
    else:
        model = load_clip(model_dir, device)
        tok_dir = str(model_dir)
    ids = CLIPTokenizer.from_dir(tok_dir)([GOOD_PROMPT, BAD_PROMPT],
                                          max_length=model.cfg.context_length)
    with torch.no_grad(), full_fp32():
        text_feats = model.encode_text(torch.tensor(ids, device=device))

    @torch.no_grad()
    def metric(frames: np.ndarray, _gt=None) -> float:
        return float(clipiqa_scores(model, text_feats, frames, device).mean())

    return metric
