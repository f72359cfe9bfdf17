"""K1, K2, K3a and K3b: non-causal flash attention, hand-written CUDA kernels.

Counterpart of ``dove_tpu/ops/pallas/flash_attention.py`` (``flash_attention``
with its custom VJP). K1 is the forward (kernel ``_fwd_kernel``), with
the per-row logsumexp in its training form; K2 its ``qk8`` form (per-tensor
int8 q and k, int32 Q K^T), the int8-dit serving mode's attention; K3a and
K3b are the backward (``_bwd_dq_kernel``, ``_bwd_dkv_kernel``). K1 and K2
live in ``csrc/flash_fwd_sm90.cu`` (one kernel template, K2 its int8
instantiation with an s8 wgmma for Q K^T) and K3a and K3b in
``csrc/flash_bwd_sm90.cu`` (wgmma, TMA, warp-specialised); each note says
what bounds the kernels on the H100 and how they differ from the TPU
schedule. Every kernel takes the model type, bf16 or fp16 (the TPU kernels
are generic in it), each as its own instantiation with its own C entry;
any other dtype on the card raises. Heads are 64 wide, or 128 for K1's
serving form alone (``flash_fwd_sm90_kernel_d128``: bf16, the online
softmax, no logsumexp); any other head dim, and any other form at 128,
raises on the card.

``flash_attention`` keeps the JAX package's ``[B, H, S, D]`` layout. On a CUDA
tensor it launches a kernel or raises; on a CPU tensor it runs the same
function in plain PyTorch (:func:`flash_attention_plain` for K1,
:func:`flash_attention_qk8_plain` for K2, :func:`flash_attention_bwd_plain`
for K3a and K3b). There is no fallback from one to the other. When an input
requires grad it goes through :class:`FlashAttention`, whose forward is K1
with the logsumexp and whose backward is K3a then K3b. Each kernel counts its
own launches (``launches``, ``launches_lse``, ``launches_qk8``,
``launches_bwd_dq``, ``launches_bwd_dkv``).
"""

from __future__ import annotations

import ctypes
import math

import torch

from dove_tpu_torch import kernels, obs
from dove_tpu_torch.obs import LaunchCounter

LOG2E = 1.4426950408889634
HEAD_DIM = 64
HEAD_DIM_WIDE = 128  # K1's bf16 online serving form only


launches = LaunchCounter()  # K1, inference forms (no logsumexp)
launches_lse = LaunchCounter()  # K1, training form (writes the logsumexp)
launches_qk8 = LaunchCounter()  # K2
launches_bwd_dq = LaunchCounter()  # K3a
launches_bwd_dkv = LaunchCounter()  # K3b


# the model types the kernels take, and the suffix of their C entries
KERNEL_DTYPES = {torch.bfloat16: "", torch.float16: "_f16"}


def _library() -> ctypes.CDLL:
    """K1's library."""
    return kernels.load("flash_fwd_sm90")


def _qk8_library() -> ctypes.CDLL:
    """K2's library: K1's, whose kernel K2 is an instantiation of."""
    return kernels.load("flash_fwd_sm90")


def _bwd_library() -> ctypes.CDLL:
    """K3a's and K3b's library."""
    return kernels.load("flash_bwd_sm90")


def _entry(lib: ctypes.CDLL, name: str, argtypes: list):
    """A library's C entry ``name``, bound on first use."""
    fn = getattr(lib, name)
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return fn


def _fwd_entry(dtype: torch.dtype):
    """K1's C entry in ``dtype``: ``dove_flash_fwd_bf16`` or ``_f16``."""
    name = "dove_flash_fwd_f16" if dtype == torch.float16 else "dove_flash_fwd_bf16"
    return _entry(_library(), name, [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4
                  + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])


def _fwd_d128_entry():
    """K1's C entry at head dim 128 (bf16, online, no logsumexp)."""
    return _entry(_library(), "dove_flash_fwd_d128_bf16",
                  [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4
                  + [ctypes.c_float, ctypes.c_void_p])


def _qk8_entry(dtype: torch.dtype):
    """K2's C entry with V and O in ``dtype``."""
    return _entry(_qk8_library(), "dove_flash_fwd_qk8" + KERNEL_DTYPES[dtype],
                  [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4
                  + [ctypes.c_void_p, ctypes.c_void_p])


def _bwd_entry(name: str, dtype: torch.dtype):
    """K3a's (``dq``) or K3b's (``dkv``) C entry in ``dtype``."""
    tail = [ctypes.c_int] * 4 + [ctypes.c_float, ctypes.c_void_p]
    return _entry(_bwd_library(), f"dove_flash_bwd_{name}" + KERNEL_DTYPES[dtype],
                  [ctypes.c_void_p] * (7 if name == "dq" else 8) + tail)


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
    * log2 e) in the TPU kernel's order, left on the device (the span
    ``dit.quantize``)."""
    with obs.span("dit.quantize"):
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


def _check_cuda_inputs(q, k, v, qk8: bool = False) -> tuple[int, int, int, int, int]:
    """Raise on what the kernels do not take -> (B, H, Sq, Skv, D): v in a
    model type (bf16 or fp16), q and k in v's type, or int8 codes (K2)."""
    if v.dtype not in KERNEL_DTYPES:
        raise ValueError(f"the CUDA kernels take bf16 or fp16 v, got {v.dtype}")
    qk_dtype = torch.int8 if qk8 else v.dtype
    for name, t, want in (("q", q, qk_dtype), ("k", k, qk_dtype), ("v", v, v.dtype)):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if t.dtype != want:
            raise ValueError(f"the CUDA kernel takes {want} {name}, got {t.dtype}")
        if t.ndim != 4:
            raise ValueError(f"{name} must be [B, H, S, D], got {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    B, H, Sq, D = q.shape
    if D not in (HEAD_DIM, HEAD_DIM_WIDE):
        raise ValueError(f"the CUDA kernels take head_dim {HEAD_DIM} or {HEAD_DIM_WIDE}, "
                         f"got {D}")
    if D == HEAD_DIM_WIDE and (qk8 or v.dtype != torch.bfloat16):
        raise ValueError(f"head_dim {HEAD_DIM_WIDE} runs K1's bf16 form only, got "
                         f"{'int8 codes' if qk8 else v.dtype}")
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
    the device; nothing here waits for it. The kernel's TMA loads need
    16-byte aligned data.

    The kernel reads each int32 logit x as the fp32 12582912 + x and scales
    it with one FFMA by the factor rounded to 22 significant bits, which
    gives x * factor within a relative 2^-22 of JAX's ``float(x) * factor``."""
    if q8.device.type != "cuda":
        raise ValueError(f"K2 runs on cuda, not {q8.device}")
    B, H, Sq, Skv, D = _check_cuda_inputs(q8, k8, v, qk8=True)
    if (factor.device != q8.device or factor.dtype != torch.float32
            or factor.numel() != 1):
        raise ValueError("the logit factor must be one fp32 value on q's device")
    for name, t in (("q8", q8), ("k8", k8), ("v", v)):
        if t.data_ptr() % 16:
            raise ValueError(f"{name}'s data is not 16-byte aligned")
    out = torch.empty(q8.shape, dtype=v.dtype, device=v.device)
    fn = _qk8_entry(v.dtype)
    with torch.cuda.device(q8.device):
        stream = torch.cuda.current_stream(q8.device).cuda_stream
        rc = fn(
            q8.data_ptr(), k8.data_ptr(), v.data_ptr(), out.data_ptr(),
            B * H, Sq, Skv, D, factor.data_ptr(), stream,
        )
    if rc != 0:
        raise RuntimeError(f"flash_fwd_qk8 kernel launch failed: cudaError_t {rc}")
    launches_qk8.add(q8.shape)
    return out


def flash_attention_plain(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    scale: float | None = None,
    bounded_logits: bool = False,
    with_lse: bool = False,
) -> torch.Tensor | tuple[torch.Tensor, torch.Tensor]:
    """The kernel's function in plain PyTorch, one (batch, head) at a time so
    that the fp32 ``[Sq, Skv]`` logits of a long sequence fit.

    fp32 logits; ``bounded_logits`` takes ``exp2(s * scale * log2 e)`` with no
    max, otherwise ``exp(s - rowmax)``; fp32 row sums; the probabilities are
    cast to ``v``'s dtype before the P V product, as the kernel does.
    ``with_lse`` also returns the fp32 ``[B, H, Sq]`` logsumexp of the scaled
    logits: ``log l`` in the bounded form, ``rowmax + log l`` otherwise."""
    B, H, Sq, D = q.shape
    sc = scale if scale is not None else 1.0 / math.sqrt(D)
    out = torch.empty(q.shape, dtype=v.dtype, device=q.device)
    lse = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
    for b in range(B):
        for h in range(H):
            dots = q[b, h].float() @ k[b, h].float().T
            if bounded_logits:
                p = torch.exp2(dots * (sc * LOG2E))
                m = 0.0
            else:
                s = dots * sc
                m = s.amax(dim=-1)
                p = torch.exp(s - m[:, None])
            denom = p.sum(dim=-1)
            acc = p.to(v.dtype).float() @ v[b, h].float()
            out[b, h] = (acc / denom[:, None]).to(v.dtype)
            lse[b, h] = m + torch.log(denom)
    return (out, lse) if with_lse else out


def _delta(out: torch.Tensor, do: torch.Tensor) -> torch.Tensor:
    """delta = rowsum(dO * O) in fp32, [B, H, Sq]: the backward's per-row
    term that the TPU wrapper also computes outside its kernels."""
    return (do.float() * out.float()).sum(dim=-1)


def flash_bwd_dq_plain(q, k, v, do, lse, delta, scale: float) -> torch.Tensor:
    """K3a's function in plain PyTorch, one (batch, head) at a time: the
    logits recomputed in fp32, p = exp(s - lse), ds = p (dO V^T - delta)
    scale, and dQ = ds K with ds cast to k's dtype first; dQ in q's dtype."""
    dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    for b in range(q.shape[0]):
        for h in range(q.shape[1]):
            p = torch.exp(q[b, h].float() @ k[b, h].float().T * scale
                          - lse[b, h, :, None])
            dp = do[b, h].float() @ v[b, h].float().T
            ds = p * (dp - delta[b, h, :, None]) * scale
            dq[b, h] = (ds.to(k.dtype).float() @ k[b, h].float()).to(q.dtype)
    return dq


def flash_bwd_dkv_plain(
    q, k, v, do, lse, delta, scale: float,
) -> tuple[torch.Tensor, torch.Tensor]:
    """K3b's function in plain PyTorch, in the kernel's transposed layout
    s^T = K Q^T: dV = p^T dO with p^T cast to dO's dtype, dK = ds^T Q with
    ds^T cast to q's dtype; fp32 sums, outputs in k's and v's dtypes."""
    dk = torch.empty(k.shape, dtype=k.dtype, device=k.device)
    dv = torch.empty(v.shape, dtype=v.dtype, device=v.device)
    for b in range(q.shape[0]):
        for h in range(q.shape[1]):
            pt = torch.exp(k[b, h].float() @ q[b, h].float().T * scale
                           - lse[b, h, None, :])
            dv[b, h] = (pt.to(do.dtype).float() @ do[b, h].float()).to(v.dtype)
            dpt = v[b, h].float() @ do[b, h].float().T
            dst = pt * (dpt - delta[b, h, None, :]) * scale
            dk[b, h] = (dst.to(q.dtype).float() @ q[b, h].float()).to(k.dtype)
    return dk, dv


def flash_attention_bwd_plain(
    q, k, v, out, lse, do, scale: float,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K3a and K3b in plain PyTorch -> (dq, dk, dv), from the forward's
    output and logsumexp and the output's gradient ``do``."""
    delta = _delta(out, do)
    dq = flash_bwd_dq_plain(q, k, v, do, lse, delta, scale)
    dk, dv = flash_bwd_dkv_plain(q, k, v, do, lse, delta, scale)
    return dq, dk, dv


def flash_fwd_launch(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float,
    bounded_logits: bool, with_lse: bool,
) -> tuple[torch.Tensor, torch.Tensor | None]:
    """Launch K1 -> (out, lse or None). ``with_lse`` takes the training form,
    which also writes the fp32 [B, H, Sq] logsumexp, and counts its launch
    in ``launches_lse`` instead of ``launches``. The kernel's TMA loads need
    16-byte aligned data."""
    if q.device.type != "cuda":
        raise ValueError(f"K1 runs on cuda, not {q.device}")
    B, H, Sq, Skv, D = _check_cuda_inputs(q, k, v)
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.data_ptr() % 16:
            raise ValueError(f"{name}'s data is not 16-byte aligned")
    if D == HEAD_DIM_WIDE:
        if bounded_logits or with_lse:
            raise ValueError(f"head_dim {HEAD_DIM_WIDE} runs K1's online form without "
                             "the logsumexp only")
        out = torch.empty_like(q)
        with torch.cuda.device(q.device):
            stream = torch.cuda.current_stream(q.device).cuda_stream
            rc = _fwd_d128_entry()(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                                   B * H, Sq, Skv, D, float(scale), stream)
        if rc != 0:
            raise RuntimeError(f"flash_fwd d128 kernel launch failed: cudaError_t {rc}")
        launches.add(q.shape)
        return out, None
    out = torch.empty_like(q)
    lse = (torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
           if with_lse else None)
    fn = _fwd_entry(q.dtype)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = fn(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse.data_ptr() if with_lse else None,
            B * H, Sq, Skv, D, float(scale), int(bool(bounded_logits)), stream,
        )
    if rc != 0:
        raise RuntimeError(f"flash_fwd kernel launch failed: cudaError_t {rc}")
    (launches_lse if with_lse else launches).add(q.shape)
    return out, lse


def _check_bwd_inputs(q, k, v, do, lse, delta) -> tuple[int, int, int, int, int]:
    if q.device.type != "cuda":
        raise ValueError(f"K3a and K3b run on cuda, not {q.device}")
    B, H, Sq, Skv, D = _check_cuda_inputs(q, k, v)
    if D != HEAD_DIM:
        raise ValueError(f"K3a and K3b take head_dim {HEAD_DIM}, got {D}")
    if do.shape != q.shape or do.dtype != q.dtype or not do.is_contiguous():
        raise ValueError("do must be a contiguous tensor of q's shape and dtype")
    for name, t in (("lse", lse), ("delta", delta)):
        if (t.shape != (B, H, Sq) or t.dtype != torch.float32
                or not t.is_contiguous() or t.device != q.device):
            raise ValueError(f"{name} must be contiguous fp32 [B, H, Sq] on q's device")
    # the kernels' TMA loads
    for name, t in (("q", q), ("k", k), ("v", v), ("do", do)):
        if t.data_ptr() % 16:
            raise ValueError(f"{name}'s data is not 16-byte aligned")
    return B, H, Sq, Skv, D


def flash_bwd_dq_launch(q, k, v, do, lse, delta, scale: float) -> torch.Tensor:
    """Launch K3a -> dq: the CUDA counterpart of :func:`flash_bwd_dq_plain`."""
    B, H, Sq, Skv, D = _check_bwd_inputs(q, k, v, do, lse, delta)
    dq = torch.empty_like(q)
    fn = _bwd_entry("dq", q.dtype)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = fn(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
            B * H, Sq, Skv, D, float(scale), stream,
        )
    if rc != 0:
        raise RuntimeError(f"flash_bwd_dq kernel launch failed: cudaError_t {rc}")
    launches_bwd_dq.add(q.shape)
    return dq


def flash_bwd_dkv_launch(
    q, k, v, do, lse, delta, scale: float,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch K3b -> (dk, dv): the CUDA counterpart of
    :func:`flash_bwd_dkv_plain`."""
    B, H, Sq, Skv, D = _check_bwd_inputs(q, k, v, do, lse, delta)
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    fn = _bwd_entry("dkv", q.dtype)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = fn(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            B * H, Sq, Skv, D, float(scale), stream,
        )
    if rc != 0:
        raise RuntimeError(f"flash_bwd_dkv kernel launch failed: cudaError_t {rc}")
    launches_bwd_dkv.add(q.shape)
    return dk, dv


class FlashAttention(torch.autograd.Function):
    """Attention with the flash backward: the counterpart of the JAX
    package's ``custom_vjp`` (``_fa_fwd`` / ``_fa_bwd``).

    forward: K1 with the logsumexp (its plain version on a CPU tensor, or
    when ``plain``), saving q, k, v, out and lse; returns (out, lse), lse not
    differentiable. backward: delta = rowsum(dO * O) in torch, then K3a and
    K3b (their plain versions on a CPU tensor, or when ``plain``)."""

    @staticmethod
    def forward(ctx, q, k, v, scale: float, bounded_logits: bool, plain: bool):
        if plain or q.device.type == "cpu":
            out, lse = flash_attention_plain(q, k, v, scale, bounded_logits,
                                             with_lse=True)
        else:
            out, lse = flash_fwd_launch(q, k, v, scale, bounded_logits, True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.scale, ctx.plain = scale, plain
        ctx.mark_non_differentiable(lse)
        return out, lse

    @staticmethod
    def backward(ctx, do, _dlse):
        q, k, v, out, lse = ctx.saved_tensors
        do = do.contiguous()
        if ctx.plain or q.device.type == "cpu":
            dq, dk, dv = flash_attention_bwd_plain(q, k, v, out, lse, do, ctx.scale)
        else:
            delta = _delta(out, do)
            dq = flash_bwd_dq_launch(q, k, v, do, lse, delta, ctx.scale)
            dk, dv = flash_bwd_dkv_launch(q, k, v, do, lse, delta, ctx.scale)
        return dq, dk, dv, None, None, None


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    scale: float | None = None,
    bounded_logits: bool = False,
    qk_int8: bool = False,
    with_lse: bool = False,
) -> torch.Tensor | tuple[torch.Tensor, torch.Tensor]:
    """Non-causal attention. q: [B, H, Sq, D]; k, v: [B, H, Skv, D] ->
    [B, H, Sq, D].

    bounded_logits: the caller promises |scale * q.k| stays well inside the
    fp32 exp range (the DiT's qk-layernorm does), so the running max and the
    accumulator rescale are dropped.

    qk_int8 (K2, inference only, needs bounded_logits): q and k are
    quantized per tensor to int8 here, as the TPU wrapper does outside its
    kernel, and Q K^T runs on int8 codes; with grad it raises, as in JAX.

    with_lse returns (out, lse), lse the fp32 [B, H, Sq] logsumexp of the
    scaled logits (K1's training form). When q, k or v requires grad the call
    goes through :class:`FlashAttention`, whose backward is K3a and K3b."""
    if qk_int8 and not bounded_logits:
        raise ValueError("qk_int8 flash attention requires bounded_logits")
    grad = torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v))
    if qk_int8 and (grad or with_lse):
        raise NotImplementedError(
            "qk_int8 flash attention is inference-only (no logsumexp, no backward)")
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"flash_attention runs on cuda or cpu, not {q.device}")
    sc = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    if grad:
        out, lse = FlashAttention.apply(q, k, v, sc, bounded_logits, False)
        return (out, lse) if with_lse else out
    if qk_int8:
        if q.device.type == "cuda":  # the kernel's checks come before any work
            _check_cuda_inputs(q, k, v, qk8=q.shape[-1] == HEAD_DIM_WIDE)
        q8, k8, factor = quantize_qk_pair(q, k, sc)
        if q.device.type == "cpu":
            return flash_attention_qk8_plain(q8, k8, v, factor)
        return flash_qk8_launch(q8, k8, v, factor)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, scale, bounded_logits, with_lse)
    out, lse = flash_fwd_launch(q, k, v, sc, bounded_logits, with_lse)
    return (out, lse) if with_lse else out
