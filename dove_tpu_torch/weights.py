"""Checkpoint loading for the PyTorch port.

The port's modules are named like the diffusers checkpoints
(``CogVideoXTransformer3DModel``, ``AutoencoderKLCogVideoX``), so converting
a released state dict is a ``load_state_dict``: torch's Linear [out, in] and
Conv [O, I, k...] layouts are the checkpoint's own. ``from_jax_params`` takes
the JAX package's parameter trees (as NumPy arrays) through the same path by
first undoing the three things that tree does differently: DiT blocks stacked
on a leading axis for ``lax.scan``, linear kernels stored [d_in, d_out], and
conv kernels stored [kt, kh, kw, Cin, Cout] (2D, the 2B's patch conv among
them: [kh, kw, Cin, Cout]); the 2B's ``pos_embedding`` table goes across as
it is. It
also takes a DiT tree that the JAX package's ``quantize_dit`` made (int8
``kernel_q`` or ``kernel_w8`` beside fp32 ``kernel_scale`` of [L, 1, out]):
the port's DiT then carries the same codes and scales in ``QLinear`` or
``W8Linear`` modules. A VAE tree that ``quantize_vae`` made (conv leaves
with ``kernel_q``, ``kernel_scale`` and optionally ``kernel_ksum`` and
``equalize_inv``) likewise gives a VAE with the same codes in ``QConv3d``s.
``from_jax_lora`` carries the JAX package's LoRA tree across, ``from_jax_vgg``
its VGG16 and perceptual heads, ``from_jax_t5`` its T5 encoder, and
``fuse_lora_into_dit`` fuses a peft adapter (the trained LoRA's export) into
a DiT so that the pipeline serves it.

Files are read through ``safetensors_io``, the port's own reader of the
format: the ``safetensors`` package is not needed.
"""

from __future__ import annotations

import json
import re
from pathlib import Path
from typing import Any, Mapping, Sequence

import numpy as np
import torch
from torch import nn

from dove_tpu_torch import safetensors_io
from dove_tpu_torch.config import DiTConfig, PipelineConfig, VAEConfig
from dove_tpu_torch.eval.vgg import VGG16, vgg_from_kernels
from dove_tpu_torch.models.dit import CogVideoXTransformer3D, stored_pos_embedding
from dove_tpu_torch.models.vae import AutoencoderKLCogVideoX
from dove_tpu_torch.ops import quant

Tensors = Mapping[str, Any]  # name -> torch.Tensor or np.ndarray


def load_safetensors_dir(subdir: str | Path) -> dict[str, torch.Tensor]:
    """All tensors of a diffusers model subfolder (sharded or single file)."""
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
        for k, t in safetensors_io.load_file(f).items():
            if k in tensors:
                raise ValueError(
                    f"duplicate tensor {k!r} across files in {subdir} "
                    "(multiple precision variants?) — keep one variant"
                )
            tensors[k] = t
    return tensors


def _load_into(module: nn.Module, tensors: Tensors) -> None:
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
            # the model was built in its dtype; int8 codes and fp32
            # quantization scales keep theirs
            dst.copy_(src.to(dst.dtype))


def convert_dit(
    tensors: Tensors, cfg: DiTConfig, dtype: torch.dtype = torch.bfloat16,
    device="cpu", quantized: str | None = None,
) -> CogVideoXTransformer3D:
    """diffusers CogVideoXTransformer3DModel state dict -> the port's DiT.

    The 2B's ``patch_embed.pos_embedding`` is taken from the state dict when
    it is there and built from the config when not (diffusers registers it
    as a non-persistent buffer, so a saved checkpoint may lack it).
    quantized ("w8a8" or "w8a16"): the state dict holds int8 ``weight_q``
    and fp32 ``scale`` for the linears ``quantize_dit`` quantizes."""
    if (not cfg.use_rotary_positional_embeddings
            and "patch_embed.pos_embedding" not in tensors):
        tensors = {**tensors, "patch_embed.pos_embedding": stored_pos_embedding(cfg)}
    with torch.device("meta"):
        model = CogVideoXTransformer3D(cfg, dtype=dtype)
        if quantized is not None:
            cls = {"w8a8": quant.QLinear, "w8a16": quant.W8Linear}[quantized]
            for block in model.transformer_blocks:
                for parent_path, name in quant.QUANTIZED_LINEARS:
                    parent = block.get_submodule(parent_path)
                    lin = parent.get_submodule(name)
                    setattr(parent, name, cls.empty(
                        lin.in_features, lin.out_features, lin.bias is not None,
                        dtype=dtype))
    model = model.to_empty(device=device)
    _load_into(model, tensors)
    return model.eval().requires_grad_(False)


def convert_vae(
    tensors: Tensors, cfg: VAEConfig, dtype: torch.dtype = torch.bfloat16,
    device="cpu",
) -> AutoencoderKLCogVideoX:
    """diffusers AutoencoderKLCogVideoX state dict -> the port's VAE. A conv
    whose entry holds ``weight_q`` (``QConv3d``'s state) becomes a
    ``QConv3d``."""
    with torch.device("meta"):
        vae = AutoencoderKLCogVideoX(cfg, dtype=dtype)
        for _, path, parent, attr, conv in quant.quantizable_convs(vae):
            prefix = f"{path}."
            if f"{prefix}weight_q" in tensors:
                kt = conv.weight.shape[2] if conv.weight.ndim == 5 else 1
                setattr(parent, attr, quant.QConv3d.empty(
                    conv.in_channels, conv.out_channels, kt,
                    f"{prefix}kernel_ksum" in tensors,
                    f"{prefix}equalize_inv" in tensors,
                    conv.bias is not None, dtype=dtype))
    vae = vae.to_empty(device=device)
    _load_into(vae, tensors)
    return vae.eval().requires_grad_(False)


def load_dit(model_dir: str | Path, cfg: DiTConfig, dtype=torch.bfloat16,
             device="cpu") -> CogVideoXTransformer3D:
    return convert_dit(load_safetensors_dir(Path(model_dir) / "transformer"),
                       cfg, dtype, device)


def load_vae(model_dir: str | Path, cfg: VAEConfig, dtype=torch.bfloat16,
             device="cpu") -> AutoencoderKLCogVideoX:
    return convert_vae(load_safetensors_dir(Path(model_dir) / "vae"),
                       cfg, dtype, device)


def _wan_module(cls, cfg, tensors: Tensors, dtype, device) -> nn.Module:
    with torch.device("meta"):
        module = cls(cfg, dtype=dtype)
    state = {k: torch.as_tensor(tensors[k]).to(device=device, dtype=dtype)
             for k in module.state_dict() if k in tensors}
    module.load_state_dict(state, strict=True, assign=True)
    return module.eval()


def load_wan_dit(model_dir: str | Path, cfg, dtype=torch.bfloat16, device="cpu"):
    """A Wan2.1 release folder's DiT: the safetensors shards at its root,
    by ``WanModel``'s parameter names (a missing one raises)."""
    from dove_tpu_torch.models.wan_dit import WanModel

    return _wan_module(WanModel, cfg, load_safetensors_dir(model_dir), dtype, device)


def load_wan_vae(model_dir: str | Path, cfg, dtype=torch.bfloat16, device="cpu"):
    """A Wan2.1 release folder's VAE: the state dict of ``Wan2.1_VAE.pth``."""
    from dove_tpu_torch.config import WAN_VAE_FILE
    from dove_tpu_torch.models.wan_vae import WanVAE_

    state = torch.load(Path(model_dir) / WAN_VAE_FILE, map_location="cpu", weights_only=True)
    return _wan_module(WanVAE_, cfg, state, dtype, device)


def load_wan_prompt(path: str | Path, text_len: int, text_dim: int,
                    dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """A umT5 prompt embedding [L <= text_len, text_dim] (safetensors under
    ``prompt_embedding``, or .npy), padded with zero rows to ``text_len``,
    as ``WanModel`` pads its context."""
    path = Path(path)
    emb = (torch.from_numpy(np.load(path)) if path.suffix == ".npy"
           else safetensors_io.load_file(path)["prompt_embedding"])
    emb = emb.reshape(-1, emb.shape[-1])
    if emb.shape[0] > text_len or emb.shape[1] != text_dim:
        raise ValueError(f"a Wan prompt embedding is [<= {text_len}, {text_dim}], "
                         f"got {tuple(emb.shape)}")
    return torch.nn.functional.pad(emb, (0, 0, 0, text_len - emb.shape[0])).to(dtype)


def load_prompt_embedding(
    path: str | Path, dtype: torch.dtype = torch.bfloat16
) -> torch.Tensor:
    """A cached T5 prompt embedding (e.g. the empty-prompt file shipped with
    the reference, prompt_embeddings/e3b0c4...safetensors)."""
    return safetensors_io.load_file(path)["prompt_embedding"].to(dtype)


# ---------------------------------------------------------------------------
# JAX parameter trees -> diffusers names and layouts
# ---------------------------------------------------------------------------

_DIT_RENAME = {"to_out": "to_out.0", "net_0_proj": "net.0.proj", "net_2": "net.2"}
# leaves of a quantized JAX linear -> the port's int8 module's names
_QUANT_LEAVES = {"kernel_q": "weight_q", "kernel_w8": "weight_q",
                 "kernel_scale": "scale"}
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


def _quantized_conv_leaves(leaf: Mapping[str, Any], prefix: str,
                           out: dict[str, np.ndarray]) -> None:
    """A conv leaf of the JAX package's ``quantize_vae`` -> ``QConv3d``'s
    state: codes [(kt,) 3, 3, I, O] -> [taps, O, I], the channel-summed codes
    [(kt,) 3, 3, 1, O] -> [O, 1, kt, 3, 3]."""
    codes = np.asarray(leaf["kernel_q"])
    cin, cout = codes.shape[-2:]
    kt = codes.shape[0] if codes.ndim == 5 else 1
    out[f"{prefix}weight_q"] = np.ascontiguousarray(
        codes.reshape(-1, cin, cout).transpose(0, 2, 1))
    out[f"{prefix}kernel_scale"] = np.asarray(
        leaf["kernel_scale"], np.float32).reshape(-1).copy()
    if "kernel_ksum" in leaf:
        ksum = np.asarray(leaf["kernel_ksum"], np.float32).reshape(-1, cout)
        out[f"{prefix}kernel_ksum"] = np.ascontiguousarray(
            ksum.T.reshape(cout, 1, kt, 3, 3))
    if "equalize_inv" in leaf:
        out[f"{prefix}equalize_inv"] = np.asarray(
            leaf["equalize_inv"], np.float32).reshape(-1).copy()
    if "bias" in leaf:
        out[f"{prefix}bias"] = np.array(leaf["bias"], np.float32, order="C")


def _flatten(tree: Any, prefix: str, out: dict[str, np.ndarray],
             rename: dict[str, str], causal: bool) -> None:
    """Walk a JAX tree, emitting diffusers names: "kernel"/"scale" become
    "weight", list indices become ".i", and a VAE causal conv gains ".conv"."""
    if isinstance(tree, Mapping) and np.ndim(tree.get("kernel_q", 0)) >= 4:
        _quantized_conv_leaves(tree, prefix, out)
    elif isinstance(tree, Mapping):
        for key, sub in tree.items():
            if key in _QUANT_LEAVES:
                leaf = np.asarray(sub)
                if key == "kernel_scale":  # [1, out] or [out] -> [out] fp32
                    leaf = leaf.reshape(-1).astype(np.float32)
                else:  # int8 [in, out] -> [out, in]
                    leaf = leaf.T
                out[f"{prefix}{_QUANT_LEAVES[key]}"] = np.array(leaf, order="C")
                continue
            if key == "pos_embedding":  # the 2B's positions, [1, L, dim] as stored
                out[f"{prefix}{key}"] = np.array(sub, np.float32, order="C")
                continue
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
    """The JAX package's parameter trees (NumPy leaves) -> (DiT, VAE). A
    quantized DiT or VAE tree gives a model with the same int8 codes and
    scales."""
    to_q = dit_tree["blocks"]["attn1"]["to_q"]
    quantized = ("w8a8" if "kernel_q" in to_q
                 else "w8a16" if "kernel_w8" in to_q else None)
    dit = convert_dit(jax_dit_to_diffusers(dit_tree), cfg.dit, dtype, device,
                      quantized)
    vae = convert_vae(jax_vae_to_diffusers(vae_tree), cfg.vae, dtype, device)
    return dit, vae


def from_jax_vgg(
    vgg_params: Sequence[Sequence[Mapping[str, Any]]],
    heads: Sequence[Sequence[Any]] = (),
    device="cpu",
) -> tuple[VGG16, list[list[torch.Tensor]]]:
    """The JAX package's VGG16 parameter list (per stage, per conv
    {"kernel": [3, 3, Cin, Cout] HWIO, "bias": [Cout]}, NumPy leaves) and its
    perceptual heads (DISTS's ``(alpha, beta)`` or LPIPS's ``(lins,)``, each
    a list of per-scale [C] vectors) -> (the port's frozen fp32 VGG16, the
    heads as fp32 tensors in the same nesting)."""
    convs = [(np.transpose(np.asarray(c["kernel"], np.float32), (3, 2, 0, 1)),
              np.asarray(c["bias"], np.float32))
             for stage in vgg_params for c in stage]
    heads_t = [[torch.tensor(np.asarray(v, np.float32), device=device) for v in head]
               for head in heads]
    return vgg_from_kernels(convs, device), heads_t


def from_jax_t5(params: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    """The JAX package's T5 tree (``init_t5_params`` / ``convert_t5``'s,
    NumPy leaves, [in, out] kernels) -> the state dict of the port's
    ``models.t5.T5Encoder`` ([out, in] linears), dtypes as they are."""

    def t(x, transpose=False):
        x = np.asarray(x)
        return torch.from_numpy(np.array(x.T if transpose else x))

    out = {"embed": t(params["embed"]["weight"]),
           "rel_emb": t(params["rel_emb"]["weight"]),
           "final_ln": t(params["final_ln"]["weight"])}
    for i, blk in enumerate(params["blocks"]):
        out[f"blocks.{i}.ln0"] = t(blk["ln0"]["weight"])
        out[f"blocks.{i}.ln1"] = t(blk["ln1"]["weight"])
        for name in ("q", "k", "v", "o"):
            out[f"blocks.{i}.{name}"] = t(blk["attn"][name]["kernel"], True)
        for name in ("wi_0", "wi_1", "wo"):
            out[f"blocks.{i}.{name}"] = t(blk["ffn"][name]["kernel"], True)
    return out


# ---------------------------------------------------------------------------
# LoRA
# ---------------------------------------------------------------------------

def from_jax_lora(
    tree: Mapping[str, Mapping[str, Any]], device="cpu", dtype=torch.float32,
) -> dict[str, dict[str, torch.Tensor]]:
    """The JAX package's LoRA tree ({target: {"A": [L, in, r], "B": [L, r,
    out]}}, NumPy leaves) -> the port's, which keeps the same layout; the
    tensors require grad, ready to train."""
    from dove_tpu_torch.train.lora import TARGETS

    if set(tree) - set(TARGETS) or set(tree["to_q"]) != {"A", "B"}:
        raise ValueError(f"not a LoRA tree: {sorted(tree)}")
    return {t: {ab: torch.tensor(np.asarray(x), dtype=dtype, device=device)
                .requires_grad_() for ab, x in d.items()}
            for t, d in tree.items()}


_LORA_KEY = re.compile(
    r"transformer_blocks\.(\d+)\.attn1\.(to_q|to_k|to_v|to_out\.0)\."
    r"lora_([AB])\.weight$"
)


def fuse_lora_into_dit(
    dit: CogVideoXTransformer3D, lora_tensors: Tensors, scale: float = 1.0,
) -> CogVideoXTransformer3D:
    """Fuse peft LoRA weights into the DiT in place, W += scale * B @ A, and
    return it: the counterpart of ``dove_tpu.weights.fuse_lora_into_dit``
    (the reference's load_lora_weights + fuse_lora). Keys follow the
    diffusers export (``pytorch_lora_weights.safetensors``); a leading
    "transformer." is tolerated. The tensors may be NumPy arrays or torch
    tensors of any float dtype on any device (a bf16 file read by
    ``safetensors_io``). Each delta is computed in fp32 and cast to the
    weight's dtype before the add, as in JAX."""
    deltas: dict[tuple[int, str], dict[str, torch.Tensor]] = {}
    for key, val in lora_tensors.items():
        m = _LORA_KEY.search(key.removeprefix("transformer."))
        if m:
            deltas.setdefault((int(m.group(1)), m.group(2)), {})[m.group(3)] = (
                torch.as_tensor(val).float())
    if not deltas:
        raise ValueError("no recognizable LoRA keys found")
    n_layers = len(dit.transformer_blocks)
    with torch.no_grad():
        for (layer, target), ab in sorted(deltas.items()):
            if "A" not in ab or "B" not in ab:
                raise ValueError(
                    f"incomplete LoRA pair for layer {layer} {target}: found "
                    f"only lora_{'A' if 'A' in ab else 'B'}")
            if layer >= n_layers:
                raise ValueError(
                    f"LoRA adapter targets transformer_blocks.{layer} but the "
                    f"model has {n_layers} layers — adapter/model mismatch")
            lin = dit.transformer_blocks[layer].attn1.get_submodule(target)
            if not isinstance(lin, nn.Linear):
                raise NotImplementedError("fusing LoRA into a quantized DiT is not ported")
            delta = (ab["B"] @ ab["A"]) * scale  # [out, in]
            lin.weight += delta.to(device=lin.weight.device, dtype=lin.weight.dtype)
    return dit
