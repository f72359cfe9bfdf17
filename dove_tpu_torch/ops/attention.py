"""Joint text-video attention for the CogVideoX DiT (PyTorch).

Counterpart of ``dove_tpu/ops/attention.py``, with its dispatch rule:

  * "naive": fp32-softmax attention, exact, O(S^2) memory (the JAX
    package's "xla" backend);
  * "flash": K1 (ops/flash_attention.py): the hand-written CUDA kernel on a
    CUDA tensor, its plain PyTorch version on a CPU tensor; with gradients,
    K1 with the logsumexp and K3a/K3b as its backward;
  * "plain": K1's plain PyTorch version on any device, the reference the
    kernel is held to (chip_smoke.py runs the pipeline and a training step
    through both); with gradients, the same autograd function on the plain
    versions of K1 and K3a/K3b;
  * "flash-qk8": K2, per-tensor int8 Q K^T (the int8-dit serving mode's
    attention; needs bounded_logits): the CUDA kernel on a CUDA tensor, its
    plain version on a CPU tensor;
  * "plain-qk8": K2's plain PyTorch version on any device, its reference.

``backend=None`` takes the kernel when the tensors are on the card and the
longer side of the attention has 2048 tokens or more, and the naive path
otherwise. The naive path differentiates through plain autograd.
"""

from __future__ import annotations

import torch

from dove_tpu_torch.ops import flash_attention as fa

FLASH_MIN_SEQ = 2048


def _naive_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """q,k,v: [B, H, S, D]. fp32 logits + softmax, output in v's dtype."""
    scale = q.shape[-1] ** -0.5
    logits = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float())
    probs = torch.softmax(logits * scale, dim=-1)
    out = torch.einsum("bhqk,bhkd->bhqd", probs.to(v.dtype).float(), v.float())
    return out.to(v.dtype)


def full_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    backend: str | None = None,
    bounded_logits: bool = False,
) -> torch.Tensor:
    """Full bidirectional attention. q,k,v: [B, H, S, D] -> [B, H, S, D].

    bounded_logits: promise that |q.k/sqrt(D)| stays well inside the fp32 exp
    range, which lets the kernel drop its running max (the DiT's
    qk-layernorm guarantees it at inference)."""
    if backend is None:
        # key the threshold on the LONGER side: the naive path's logits
        # buffer is O(Sq * Skv)
        s_max = max(q.shape[-2], k.shape[-2])
        backend = "flash" if (q.is_cuda and s_max >= FLASH_MIN_SEQ) else "naive"
    if backend in ("flash", "flash-qk8"):
        return fa.flash_attention(q, k, v, bounded_logits=bounded_logits,
                                  qk_int8=backend == "flash-qk8")
    if backend == "plain":
        if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
            return fa.FlashAttention.apply(q, k, v, q.shape[-1] ** -0.5,
                                           bounded_logits, True)[0]
        return fa.flash_attention_plain(q, k, v, bounded_logits=bounded_logits)
    if backend == "plain-qk8":
        if not bounded_logits:
            raise ValueError("qk_int8 flash attention requires bounded_logits")
        q8, k8, factor = fa.quantize_qk_pair(q, k, q.shape[-1] ** -0.5)
        return fa.flash_attention_qk8_plain(q8, k8, v, factor)
    if backend == "naive":
        return _naive_attention(q, k, v)
    raise ValueError(f"unknown attention backend: {backend}")
