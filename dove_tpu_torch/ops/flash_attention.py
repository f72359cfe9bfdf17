"""K1: non-causal flash-attention forward, a hand-written CUDA kernel.

Counterpart of ``dove_tpu/ops/pallas/flash_attention.py`` (``flash_attention``,
kernel ``_fwd_kernel``). The kernel lives in ``csrc/flash_fwd.cu``; its note says
what bounds it on the H100 and how it differs from the TPU schedule.

``flash_attention`` keeps the JAX package's ``[B, H, S, D]`` layout. On a CUDA
tensor it launches the kernel or raises; on a CPU tensor it runs
:func:`flash_attention_plain`, the same function in plain PyTorch. There is no
fallback from one to the other.
"""

from __future__ import annotations

import ctypes
import math

import torch

from dove_tpu_torch import kernels

LOG2E = 1.4426950408889634
HEAD_DIM = 64


class LaunchCounter:
    """Number of kernel launches: the wrapper adds one per launch, and only
    there, so a run can show that its path went through the kernel."""

    def __init__(self) -> None:
        self.count = 0

    def reset(self) -> None:
        self.count = 0


launches = LaunchCounter()


def _library() -> ctypes.CDLL:
    lib = kernels.load("flash_fwd")
    fn = lib.dove_flash_fwd_bf16
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [
            ctypes.c_float, ctypes.c_int, ctypes.c_void_p,
        ]
        fn.restype = ctypes.c_int
    return lib


def flash_attention_plain(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    scale: float | None = None,
    bounded_logits: bool = False,
) -> torch.Tensor:
    """The kernel's function in plain PyTorch, one (batch, head) at a time so
    that the fp32 ``[Sq, Skv]`` logits of a long sequence fit.

    fp32 logits; ``bounded_logits`` takes ``exp2(s * scale * log2 e)`` with no
    max, otherwise ``exp(s - rowmax)``; fp32 row sums; the probabilities are
    cast to ``v``'s dtype before the P V product, as the kernel does."""
    B, H, _, D = q.shape
    sc = scale if scale is not None else 1.0 / math.sqrt(D)
    out = torch.empty(q.shape, dtype=v.dtype, device=q.device)
    for b in range(B):
        for h in range(H):
            dots = q[b, h].float() @ k[b, h].float().T
            if bounded_logits:
                p = torch.exp2(dots * (sc * LOG2E))
            else:
                s = dots * sc
                p = torch.exp(s - s.amax(dim=-1, keepdim=True))
            denom = p.sum(dim=-1, keepdim=True)
            acc = p.to(v.dtype).float() @ v[b, h].float()
            out[b, h] = (acc / denom).to(v.dtype)
    return out


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    scale: float | None = None,
    bounded_logits: bool = False,
    qk_int8: bool = False,
    with_lse: bool = False,
) -> torch.Tensor:
    """Non-causal attention. q: [B, H, Sq, D]; k, v: [B, H, Skv, D] ->
    [B, H, Sq, D].

    bounded_logits: the caller promises |scale * q.k| stays well inside the
    fp32 exp range (the DiT's qk-layernorm does), so the running max and the
    accumulator rescale are dropped. qk_int8 (K2) and with_lse (the training
    forward that feeds K3) are not ported yet and raise."""
    if qk_int8:
        raise NotImplementedError("flash attention with int8 QK^T (K2) is not ported")
    if with_lse:
        raise NotImplementedError("flash attention with logsumexp (K3) is not ported")
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, scale, bounded_logits)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on cuda or cpu, not {q.device}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if t.dtype != torch.bfloat16:
            raise ValueError(f"the CUDA kernel takes bfloat16, {name} is {t.dtype}")
        if t.ndim != 4:
            raise ValueError(f"{name} must be [B, H, S, D], got {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    B, H, Sq, D = q.shape
    if D != HEAD_DIM:
        raise ValueError(f"the CUDA kernel supports head_dim {HEAD_DIM}, got {D}")
    if k.shape != v.shape or k.shape[:2] != (B, H) or k.shape[3] != D:
        raise ValueError(
            f"shape mismatch: q {tuple(q.shape)}, k {tuple(k.shape)}, "
            f"v {tuple(v.shape)}"
        )
    Skv = k.shape[2]
    if B * H > 65535 or Sq == 0 or Skv == 0:
        raise ValueError(f"unsupported shape: B*H={B * H}, Sq={Sq}, Skv={Skv}")
    sc = scale if scale is not None else 1.0 / math.sqrt(D)
    out = torch.empty_like(q)
    lib = _library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.dove_flash_fwd_bf16(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            B * H, Sq, Skv, D, float(sc), int(bool(bounded_logits)), stream,
        )
    if rc != 0:
        raise RuntimeError(f"flash_fwd kernel launch failed: cudaError_t {rc}")
    launches.count += 1
    return out
