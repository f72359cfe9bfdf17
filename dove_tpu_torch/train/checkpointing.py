"""Checkpoint save / rotate / resume, and the LoRA export.

Counterpart of ``dove_tpu/train/checkpointing.py``: the same
``checkpoint-{step}`` directories under the output directory, the same
rotation (keep the newest ``limit``) and resume (the newest step, parsed
from the directory name). The JAX package persists its state with orbax;
here the payload (the trainable tensors and the optimizer state) goes
through ``torch.save`` into ``checkpoint-{step}/state.pt``.
``export_lora_safetensors`` writes the peft key names and layouts the JAX
package writes. Both exports go through the port's own writer of the
format (``safetensors_io``), not the ``safetensors`` package.
"""

from __future__ import annotations

import re
import shutil
from pathlib import Path
from typing import Any, Mapping

import numpy as np
import torch

from dove_tpu_torch import safetensors_io

CHECKPOINT_PREFIX = "checkpoint-"
STATE_FILE = "state.pt"


def save_checkpoint(
    output_dir: str | Path, step: int, state: Any, *, limit: int | None = None,
) -> Path:
    """Save ``state`` (nested dicts and lists of tensors and numbers) to
    ``output_dir/checkpoint-{step}``, then keep the newest ``limit``."""
    output_dir = Path(output_dir)
    path = (output_dir / f"{CHECKPOINT_PREFIX}{step}").resolve()
    path.mkdir(parents=True, exist_ok=True)
    tmp = path / f"{STATE_FILE}.tmp"
    torch.save(state, tmp)
    tmp.replace(path / STATE_FILE)  # a crash never leaves half a file
    if limit:
        rotate_checkpoints(output_dir, limit)
    return path


def load_state(path: str | Path) -> Any:
    """A checkpoint's payload as saved, on the CPU."""
    return torch.load(Path(path) / STATE_FILE, map_location="cpu", weights_only=True)


def restore_state(state: Any, template: Any) -> Any:
    """A checkpoint's payload in the structure of ``template`` (the live
    state): every tensor is checked against the template's shape and moved
    to its device and dtype."""
    return _like(state, template, "state")


def restore_checkpoint(path: str | Path, template: Any) -> Any:
    """``restore_state`` of the checkpoint at ``path``."""
    return restore_state(load_state(path), template)


def _like(value: Any, template: Any, where: str) -> Any:
    if isinstance(template, torch.Tensor):
        if not isinstance(value, torch.Tensor) or value.shape != template.shape:
            raise ValueError(f"{where}: checkpoint holds "
                             f"{getattr(value, 'shape', type(value))}, "
                             f"want {tuple(template.shape)}")
        return value.to(device=template.device, dtype=template.dtype)
    if isinstance(template, Mapping):
        if set(value) != set(template):
            raise ValueError(f"{where}: keys {sorted(value)} != {sorted(template)}")
        return {k: _like(value[k], template[k], f"{where}.{k}") for k in template}
    if isinstance(template, (list, tuple)):
        if len(value) != len(template):
            raise ValueError(f"{where}: {len(value)} entries, want {len(template)}")
        return [_like(v, t, f"{where}[{i}]") for i, (v, t) in enumerate(zip(value, template))]
    return value


def list_checkpoints(output_dir: str | Path) -> list[tuple[int, Path]]:
    out = []
    for p in Path(output_dir).glob(f"{CHECKPOINT_PREFIX}*"):
        m = re.fullmatch(rf"{CHECKPOINT_PREFIX}(\d+)", p.name)
        if m and p.is_dir():
            out.append((int(m.group(1)), p))
    return sorted(out)


def rotate_checkpoints(output_dir: str | Path, limit: int) -> None:
    """Keep only the newest ``limit`` checkpoint directories."""
    ckpts = list_checkpoints(output_dir)
    for _, path in ckpts[: max(len(ckpts) - limit, 0)]:
        shutil.rmtree(path, ignore_errors=True)


def latest_checkpoint(output_dir: str | Path) -> tuple[int, Path] | None:
    """(step, path) of the newest checkpoint, for resume."""
    ckpts = list_checkpoints(output_dir)
    return ckpts[-1] if ckpts else None


# the JAX LoRA tree's targets -> peft module names
LORA_PEFT_NAMES = {"to_q": "to_q", "to_k": "to_k", "to_v": "to_v", "to_out": "to_out.0"}


def lora_state_dict(lora: Mapping[str, Mapping[str, Any]]) -> dict[str, np.ndarray]:
    """The LoRA tree {target: {"A": [L, in, r], "B": [L, r, out]}} as peft
    tensors: per-layer ``transformer.transformer_blocks.{i}.attn1.{t}.
    lora_A.weight`` [r, in] and ``lora_B.weight`` [out, r]."""
    sd: dict[str, np.ndarray] = {}
    for ours, ab in lora.items():
        A = torch.as_tensor(ab["A"]).detach().cpu().numpy()
        B = torch.as_tensor(ab["B"]).detach().cpu().numpy()
        target = LORA_PEFT_NAMES[ours]
        for i in range(A.shape[0]):
            pfx = f"transformer.transformer_blocks.{i}.attn1.{target}"
            sd[f"{pfx}.lora_A.weight"] = np.ascontiguousarray(A[i].T)
            sd[f"{pfx}.lora_B.weight"] = np.ascontiguousarray(B[i].T)
    return sd


def export_lora_safetensors(lora: Mapping[str, Mapping[str, Any]],
                            out_path: str | Path) -> None:
    """Write a peft/diffusers-format ``pytorch_lora_weights.safetensors``."""
    Path(out_path).parent.mkdir(parents=True, exist_ok=True)
    safetensors_io.save_file(lora_state_dict(lora), out_path)


def export_dit_safetensors(dit: torch.nn.Module | Mapping[str, torch.Tensor],
                           out_dir: str | Path, *,
                           base_config: str | Path | None = None,
                           max_shard_bytes: int = 5 * 1024**3) -> None:
    """Write the DiT (a module, or its whole state dict) as diffusers-layout
    ``diffusion_pytorch_model*.safetensors`` (sharded, with an index, past
    ``max_shard_bytes``): the port's module names are the checkpoint's, so
    its state dict is the payload."""
    import json

    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    shards: list[dict[str, torch.Tensor]] = [{}]
    size = 0
    state = dit.state_dict() if isinstance(dit, torch.nn.Module) else dit
    for k, v in state.items():
        nbytes = v.numel() * v.element_size()
        if size + nbytes > max_shard_bytes and shards[-1]:
            shards.append({})
            size = 0
        shards[-1][k] = v.detach().cpu().contiguous()
        size += nbytes
    n = len(shards)
    weight_map, total = {}, 0
    for i, shard in enumerate(shards):
        name = ("diffusion_pytorch_model.safetensors" if n == 1 else
                f"diffusion_pytorch_model-{i + 1:05d}-of-{n:05d}.safetensors")
        safetensors_io.save_file(shard, out_dir / name)
        for k, v in shard.items():
            weight_map[k] = name
            total += v.numel() * v.element_size()
    if n > 1:
        (out_dir / "diffusion_pytorch_model.safetensors.index.json").write_text(
            json.dumps({"metadata": {"total_size": total}, "weight_map": weight_map},
                       indent=2))
    if base_config is not None:
        shutil.copy(base_config, out_dir / "config.json")
