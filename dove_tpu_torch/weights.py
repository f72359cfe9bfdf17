"""Checkpoint loading for the PyTorch port.

The port's modules are named like the diffusers checkpoints
(``CogVideoXTransformer3DModel``, ``AutoencoderKLCogVideoX``), so converting
a released state dict is a ``load_state_dict``: torch's Linear [out, in] and
Conv [O, I, k...] layouts are the checkpoint's own. ``from_jax_params`` takes
the JAX package's parameter trees (as NumPy arrays) through the same path by
first undoing the three things that tree does differently: DiT blocks stacked
on a leading axis for ``lax.scan``, linear kernels stored [d_in, d_out], and
conv kernels stored [kt, kh, kw, Cin, Cout] (2D: [kh, kw, Cin, Cout]).

``safetensors`` is imported inside the functions that read files.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Any, Mapping

import numpy as np
import torch
from torch import nn

from dove_tpu_torch.config import DiTConfig, PipelineConfig, VAEConfig
from dove_tpu_torch.models.dit import CogVideoXTransformer3D
from dove_tpu_torch.models.vae import AutoencoderKLCogVideoX

Tensors = Mapping[str, Any]  # name -> torch.Tensor or np.ndarray


def load_safetensors_dir(subdir: str | Path) -> dict[str, torch.Tensor]:
    """All tensors of a diffusers model subfolder (sharded or single file)."""
    from safetensors import safe_open

    subdir = Path(subdir)
    index_files = sorted(subdir.glob("*.safetensors.index.json"))
    if len(index_files) > 1:
        raise ValueError(
            f"{subdir} has {len(index_files)} shard indexes "
            f"({[f.name for f in index_files]}) — keep one variant"
        )
    if index_files:
        index = json.loads(index_files[0].read_text())
        files = [subdir / s for s in sorted(set(index["weight_map"].values()))]
    else:
        files = sorted(subdir.glob("*.safetensors"))
    if not files:
        raise FileNotFoundError(f"no safetensors files under {subdir}")
    tensors: dict[str, torch.Tensor] = {}
    for f in files:
        with safe_open(str(f), framework="pt") as fp:
            for k in fp.keys():
                if k in tensors:
                    raise ValueError(
                        f"duplicate tensor {k!r} across files in {subdir} "
                        "(multiple precision variants?) — keep one variant"
                    )
                tensors[k] = fp.get_tensor(k)
    return tensors


def _load_into(module: nn.Module, tensors: Tensors, dtype: torch.dtype) -> None:
    """Copy every parameter of ``module`` from ``tensors``; extra checkpoint
    keys are ignored, a missing or misshapen one raises."""
    state = module.state_dict()
    missing = [k for k in state if k not in tensors]
    if missing:
        raise KeyError(f"checkpoint lacks {len(missing)} tensors, e.g. {missing[:5]}")
    with torch.no_grad():
        for name, dst in state.items():
            src = torch.as_tensor(tensors[name])
            if tuple(src.shape) != tuple(dst.shape):
                raise ValueError(
                    f"{name}: checkpoint shape {tuple(src.shape)} != {tuple(dst.shape)}"
                )
            dst.copy_(src.to(dtype))


def convert_dit(
    tensors: Tensors, cfg: DiTConfig, dtype: torch.dtype = torch.bfloat16,
    device="cpu",
) -> CogVideoXTransformer3D:
    """diffusers CogVideoXTransformer3DModel state dict -> the port's DiT."""
    with torch.device("meta"):
        model = CogVideoXTransformer3D(cfg, dtype=dtype)
    model = model.to_empty(device=device)
    _load_into(model, tensors, dtype)
    return model.eval().requires_grad_(False)


def convert_vae(
    tensors: Tensors, cfg: VAEConfig, dtype: torch.dtype = torch.bfloat16,
    device="cpu",
) -> AutoencoderKLCogVideoX:
    """diffusers AutoencoderKLCogVideoX state dict -> the port's VAE."""
    with torch.device("meta"):
        vae = AutoencoderKLCogVideoX(cfg, dtype=dtype)
    vae = vae.to_empty(device=device)
    _load_into(vae, tensors, dtype)
    return vae.eval().requires_grad_(False)


def load_dit(model_dir: str | Path, cfg: DiTConfig, dtype=torch.bfloat16,
             device="cpu") -> CogVideoXTransformer3D:
    return convert_dit(load_safetensors_dir(Path(model_dir) / "transformer"),
                       cfg, dtype, device)


def load_vae(model_dir: str | Path, cfg: VAEConfig, dtype=torch.bfloat16,
             device="cpu") -> AutoencoderKLCogVideoX:
    return convert_vae(load_safetensors_dir(Path(model_dir) / "vae"),
                       cfg, dtype, device)


def load_prompt_embedding(
    path: str | Path, dtype: torch.dtype = torch.bfloat16
) -> torch.Tensor:
    """A cached T5 prompt embedding (e.g. the empty-prompt file shipped with
    the reference, prompt_embeddings/e3b0c4...safetensors)."""
    from safetensors import safe_open

    with safe_open(str(path), framework="pt") as fp:
        emb = fp.get_tensor("prompt_embedding")
    return emb.to(dtype)


# ---------------------------------------------------------------------------
# JAX parameter trees -> diffusers names and layouts
# ---------------------------------------------------------------------------

_DIT_RENAME = {"to_out": "to_out.0", "net_0_proj": "net.0.proj", "net_2": "net.2"}
_VAE_RENAME = {"downsampler": "downsamplers.0", "upsampler": "upsamplers.0"}
_CAUSAL_CONVS = {"conv_in", "conv_out", "conv1", "conv2", "conv_y", "conv_b"}


def _torch_layout(name: str, leaf: np.ndarray) -> np.ndarray:
    if name != "kernel":
        return leaf
    if leaf.ndim == 2:  # linear [in, out] -> [out, in]
        return leaf.T
    if leaf.ndim == 4:  # conv2d [kh, kw, I, O] -> [O, I, kh, kw]
        return leaf.transpose(3, 2, 0, 1)
    if leaf.ndim == 5:  # conv3d [kt, kh, kw, I, O] -> [O, I, kt, kh, kw]
        return leaf.transpose(4, 3, 0, 1, 2)
    raise ValueError(f"unexpected kernel rank {leaf.ndim}")


def _flatten(tree: Any, prefix: str, out: dict[str, np.ndarray],
             rename: dict[str, str], causal: bool) -> None:
    """Walk a JAX tree, emitting diffusers names: "kernel"/"scale" become
    "weight", list indices become ".i", and a VAE causal conv gains ".conv"."""
    if isinstance(tree, Mapping):
        for key, sub in tree.items():
            if key in ("kernel", "scale", "bias"):
                name = "weight" if key != "bias" else "bias"
                out[f"{prefix}{name}"] = np.array(  # a writable C-order copy
                    _torch_layout(key, np.asarray(sub, np.float32)), order="C")
                continue
            seg = rename.get(key, key)
            if causal and key in _CAUSAL_CONVS:
                seg += ".conv"
            _flatten(sub, f"{prefix}{seg}.", out, rename, causal)
    elif isinstance(tree, (list, tuple)):
        for i, sub in enumerate(tree):
            _flatten(sub, f"{prefix}{i}.", out, rename, causal)
    else:
        raise TypeError(f"unexpected leaf at {prefix!r}: {type(tree)}")


def jax_dit_to_diffusers(dit_tree: Mapping[str, Any]) -> dict[str, np.ndarray]:
    """The JAX DiT tree (blocks stacked for lax.scan) -> diffusers names."""
    out: dict[str, np.ndarray] = {}
    rest = {k: v for k, v in dit_tree.items() if k != "blocks"}
    _flatten(rest, "", out, _DIT_RENAME, causal=False)
    blocks = dit_tree["blocks"]
    n_layers = np.asarray(blocks["norm1"]["linear"]["kernel"]).shape[0]

    def take(t: Any, i: int) -> Any:
        if isinstance(t, Mapping):
            return {k: take(v, i) for k, v in t.items()}
        return np.asarray(t)[i]

    for i in range(n_layers):
        _flatten(take(blocks, i), f"transformer_blocks.{i}.", out, _DIT_RENAME,
                 causal=False)
    return out


def jax_vae_to_diffusers(vae_tree: Mapping[str, Any]) -> dict[str, np.ndarray]:
    """The JAX VAE tree -> diffusers names and torch conv layouts."""
    out: dict[str, np.ndarray] = {}
    _flatten(vae_tree, "", out, _VAE_RENAME, causal=True)
    return out


def from_jax_params(
    cfg: PipelineConfig,
    dit_tree: Mapping[str, Any],
    vae_tree: Mapping[str, Any],
    dtype: torch.dtype = torch.float32,
    device="cpu",
) -> tuple[CogVideoXTransformer3D, AutoencoderKLCogVideoX]:
    """The JAX package's parameter trees (NumPy leaves) -> (DiT, VAE)."""
    dit = convert_dit(jax_dit_to_diffusers(dit_tree), cfg.dit, dtype, device)
    vae = convert_vae(jax_vae_to_diffusers(vae_tree), cfg.vae, dtype, device)
    return dit, vae
