"""LoRA on the DiT's attention projections, merged into the weights.

Counterpart of ``dove_tpu/train/lora.py``. The reference trains peft adapters
on ``to_q``, ``to_k``, ``to_v`` and ``to_out.0``; here, as in the JAX
package, the adapters are one small tree ``{target: {"A": [L, in, r],
"B": [L, r, out]}}`` stacked over the layers, and a layer's effective weight
is ``W + scale * (A @ B)^T`` (the port's linears keep torch's [out, in]
layout) computed in fp32 and rounded to the weight's dtype: that rounding is
part of the function, as in JAX. The DiT merges one layer at a time inside
its block (``CogVideoXTransformer3D.forward(lora=...)``), so gradient
checkpointing recomputes the merge rather than holding every merged copy.
"""

from __future__ import annotations

import copy
import dataclasses
import math
from typing import Mapping

import torch

from dove_tpu_torch.config import DiTConfig

TARGETS = ("to_q", "to_k", "to_v", "to_out")

LoraTree = Mapping[str, Mapping[str, torch.Tensor]]


@dataclasses.dataclass(frozen=True)
class LoraLayer:
    """One layer's adapters: target -> (A [in, r], B [r, out]), and the scale."""

    ab: dict[str, tuple[torch.Tensor, torch.Tensor]]
    scale: float


def init_lora_params(
    cfg: DiTConfig, rank: int = 128, seed: int = 2, device="cpu",
    dtype: torch.dtype = torch.float32,
) -> dict[str, dict[str, torch.Tensor]]:
    """A ~ N(0, 1/d), drawn from a generator seeded with ``seed``; B = 0, so
    training starts at the base model. The tensors require grad."""
    d, L = cfg.hidden_dim, cfg.num_layers
    gen = torch.Generator(device=device).manual_seed(seed)
    tree = {}
    for t in TARGETS:
        a = torch.randn((L, d, rank), generator=gen, device=device, dtype=dtype)
        tree[t] = {
            "A": (a / math.sqrt(d)).requires_grad_(),
            "B": torch.zeros((L, rank, d), device=device, dtype=dtype,
                             requires_grad=True),
        }
    return tree


def merged_weight(
    weight: torch.Tensor, a: torch.Tensor, b: torch.Tensor, scale: float,
) -> torch.Tensor:
    """(W.float() + scale * (A @ B)^T).to(W.dtype) for a torch-layout weight
    W [out, in], A [in, r] and B [r, out]: the JAX package's merge, whose
    kernel is W^T, in its order of operations."""
    delta = (a.float() @ b.float()) * scale  # [in, out]
    return (weight.float() + delta.T).to(weight.dtype)


def lora_layer(lora: LoraTree, i: int, scale: float) -> LoraLayer:
    return LoraLayer({t: (ab["A"][i], ab["B"][i]) for t, ab in lora.items()}, scale)


def apply_lora(dit, lora: LoraTree, scale: float = 1.0):
    """A copy of ``dit`` with every layer's adapters merged into its weights
    (the JAX package's ``apply_lora``, which returns the effective tree)."""
    out = copy.deepcopy(dit)
    with torch.no_grad():
        for i, block in enumerate(out.transformer_blocks):
            layer = lora_layer(lora, i, scale)
            for t, (a, b) in layer.ab.items():
                lin = block.attn1.to_out[0] if t == "to_out" else getattr(block.attn1, t)
                lin.weight.copy_(merged_weight(lin.weight, a, b, scale))
    return out


def lora_param_count(lora: LoraTree) -> int:
    return sum(x.numel() for ab in lora.values() for x in ab.values())
