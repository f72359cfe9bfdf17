"""K1 and K2: non-causal flash-attention forward, hand-written CUDA kernels.

Counterpart of ``dove_tpu/ops/pallas/flash_attention.py`` (``flash_attention``,
kernel ``_fwd_kernel``): K1 is its bf16 form, K2 its ``qk8`` form (per-tensor
int8 q and k, int32 Q K^T), the int8-dit serving mode's attention. Both
kernels live in ``csrc/flash_fwd.cu``, whose note says what bounds them on the
H100 and how they differ from the TPU schedule.

``flash_attention`` keeps the JAX package's ``[B, H, S, D]`` layout. On a CUDA
tensor it launches a kernel or raises; on a CPU tensor it runs the same
function in plain PyTorch (:func:`flash_attention_plain` for K1,
:func:`flash_attention_qk8_plain` for K2). There is no fallback from one to
the other. Each kernel counts its own launches (``launches``, ``launches_qk8``).
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


launches = LaunchCounter()  # K1
launches_qk8 = LaunchCounter()  # K2


def _library() -> ctypes.CDLL:
    lib = kernels.load("flash_fwd")
    fn = lib.dove_flash_fwd_bf16
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [
            ctypes.c_float, ctypes.c_int, ctypes.c_void_p,
        ]
        fn.restype = ctypes.c_int
        fn8 = lib.dove_flash_fwd_qk8
        fn8.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [
            ctypes.c_void_p, ctypes.c_void_p,
        ]
        fn8.restype = ctypes.c_int
    return lib


def quantize_qk(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """K2's per-tensor symmetric int8 quantizer -> (int8 codes, fp32 scalar
    scale), a copy of the TPU wrapper's as XLA compiles it: its floor is 1e-6
    (not the linears' 1e-12), amax times the fp32 reciprocal of 127, a true
    division, round half to even, clip to +-127."""
    xf = x.float()
    s_x = xf.abs().amax().clamp_min(1e-6) * (1.0 / 127.0)
    return torch.round(xf / s_x).clamp_(-127, 127).to(torch.int8), s_x


def quantize_qk_pair(
    q: torch.Tensor, k: torch.Tensor, scale: float
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K2's inputs from float q and k -> (q8, k8, factor): the int8 codes of
    each and the fp32 factor on their int32 logits, (s_q * s_k) * fp32(scale
    * log2 e) in the TPU kernel's order, left on the device."""
    q8, s_q = quantize_qk(q)
    k8, s_k = quantize_qk(k)
    factor = (s_q * s_k) * torch.tensor(scale * LOG2E, dtype=torch.float32,
                                        device=s_q.device)
    return q8, k8, factor


def flash_attention_qk8_plain(
    q8: torch.Tensor, k8: torch.Tensor, v: torch.Tensor, factor: torch.Tensor,
) -> torch.Tensor:
    """K2's function in plain PyTorch, one (batch, head) at a time: int8
    codes q8 [B, H, Sq, D] and k8 [B, H, Skv, D], v, and the fp32 factor on
    the logits, all as :func:`quantize_qk_pair` makes them.

    The codes multiply as fp32: every partial sum of a 64-deep product of
    int8 values is below 127 * 127 * 64 < 2^24, so the product is exact as
    long as TF32 is off. Then exp2(dots * factor) with no max (the bounded
    form), fp32 row sums, and P cast to v's dtype before P V."""
    B, H = q8.shape[:2]
    out = torch.empty(q8.shape, dtype=v.dtype, device=v.device)
    for b in range(B):
        for h in range(H):
            dots = q8[b, h].float() @ k8[b, h].float().T
            p = torch.exp2(dots * factor)
            denom = p.sum(dim=-1, keepdim=True)
            acc = p.to(v.dtype).float() @ v[b, h].float()
            out[b, h] = (acc / denom).to(v.dtype)
    return out


def _check_cuda_inputs(q, k, v, qk_dtype: torch.dtype) -> tuple[int, int, int, int, int]:
    """Raise on what the kernels do not take -> (B, H, Sq, Skv, D)."""
    for name, t, want in (("q", q, qk_dtype), ("k", k, qk_dtype),
                          ("v", v, torch.bfloat16)):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if t.dtype != want:
            raise ValueError(f"the CUDA kernel takes {want} {name}, got {t.dtype}")
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
    return B, H, Sq, Skv, D


def flash_qk8_launch(
    q8: torch.Tensor, k8: torch.Tensor, v: torch.Tensor, factor: torch.Tensor,
) -> torch.Tensor:
    """Launch K2 on int8 codes (the kernel alone, no quantizer): the CUDA
    counterpart of :func:`flash_attention_qk8_plain`. The factor stays on
    the device; nothing here waits for it."""
    if q8.device.type != "cuda":
        raise ValueError(f"K2 runs on cuda, not {q8.device}")
    B, H, Sq, Skv, D = _check_cuda_inputs(q8, k8, v, torch.int8)
    if (factor.device != q8.device or factor.dtype != torch.float32
            or factor.numel() != 1):
        raise ValueError("the logit factor must be one fp32 value on q's device")
    out = torch.empty(q8.shape, dtype=v.dtype, device=v.device)
    lib = _library()
    with torch.cuda.device(q8.device):
        stream = torch.cuda.current_stream(q8.device).cuda_stream
        rc = lib.dove_flash_fwd_qk8(
            q8.data_ptr(), k8.data_ptr(), v.data_ptr(), out.data_ptr(),
            B * H, Sq, Skv, D, factor.data_ptr(), stream,
        )
    if rc != 0:
        raise RuntimeError(f"flash_fwd_qk8 kernel launch failed: cudaError_t {rc}")
    launches_qk8.count += 1
    return out


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
    accumulator rescale are dropped.

    qk_int8 (K2, inference only, needs bounded_logits): q and k are
    quantized per tensor to int8 here, as the TPU wrapper does outside its
    kernel, and Q K^T runs on int8 codes. with_lse (the training forward
    that feeds K3) is not ported yet and raises."""
    if qk_int8 and not bounded_logits:
        raise ValueError("qk_int8 flash attention requires bounded_logits")
    if with_lse:
        raise NotImplementedError("flash attention with logsumexp (K3) is not ported")
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"flash_attention runs on cuda or cpu, not {q.device}")
    sc = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    if qk_int8:
        if q.device.type == "cuda":  # the kernel's checks come before any work
            _check_cuda_inputs(q, k, v, torch.bfloat16)
        q8, k8, factor = quantize_qk_pair(q, k, sc)
        if q.device.type == "cpu":
            return flash_attention_qk8_plain(q8, k8, v, factor)
        return flash_qk8_launch(q8, k8, v, factor)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, scale, bounded_logits)
    B, H, Sq, Skv, D = _check_cuda_inputs(q, k, v, torch.bfloat16)
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
