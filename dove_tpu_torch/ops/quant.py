"""Post-training int8 quantization of the DiT's linears (W8A8 and W8A16).

Counterpart of the DiT half of ``dove_tpu/ops/quant.py``:

  * weights: symmetric per-output-channel int8, quantized once at load time
    (``quantize_weight``); the JAX package quantizes the layer-stacked
    kernels per layer, which for one layer is the same arithmetic;
  * activations: symmetric per-row (token) int8 with a runtime scale
    (``dynamic_quant_rows``), which folds exactly into the epilogue;
  * int8 x int8 -> int32 on the tensor cores (``torch._int_mm``, cuBLASLt;
    the JAX package leaves this GEMM to XLA as well), then the fp32 dequant
    epilogue ``acc * (s_x * s_w) + bias``, cast to the activation dtype.

``QLinear`` is the W8A8 form (``kernel_q`` in the JAX tree), ``W8Linear`` the
weight-only form (``kernel_w8``: int8 storage, bf16 matmul, exact
activations). ``quantize_dit`` swaps them in, in place, for the six hot
linears of every block: attention q/k/v/out and both MLP projections.

The arithmetic is the JAX package's as XLA compiles it, so the int8 codes and
scales come out the same: the scale is ``max(amax, 1e-12)`` times the fp32
reciprocal of 127 (XLA rewrites a division by a constant into that product),
and the code a true division by the scale and ``torch.round`` (halves to
even, like ``jnp.round``) before the clip.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

EPS = 1e-12
INV_127 = 1.0 / 127.0  # taken as fp32 by the tensor ops, as XLA folds it
# torch._int_mm on the card takes more than 16 rows and inner and output
# sizes that are multiples of 8; the wrapper pads up to that with zeros,
# which leave the int32 products unchanged.
_MIN_ROWS = 17
_ALIGN = 8


def quantize_weight(w: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-output-channel int8 of a torch-layout weight [out, in]
    -> (int8 [out, in], fp32 scale [out])."""
    wf = w.float()
    amax = wf.abs().amax(dim=1)
    scale = amax.clamp_min(EPS) * INV_127
    w_q = torch.round(wf / scale[:, None]).clamp_(-127, 127).to(torch.int8)
    return w_q, scale


def dynamic_quant_rows(x2: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-row int8 with runtime scales: [M, K] -> (int8 [M, K],
    fp32 [M, 1]). The row (token) axis of x @ w is never reduced, so a
    per-row scale folds exactly into the epilogue."""
    xf = x2.float()
    amax = xf.abs().amax(dim=1, keepdim=True)
    scale = amax.clamp_min(EPS) * INV_127
    x_q = torch.round(xf / scale).clamp_(-127, 127).to(torch.int8)
    return x_q, scale


def _pad_to(t: torch.Tensor, dim: int, size: int) -> torch.Tensor:
    extra = size - t.shape[dim]
    if extra <= 0:
        return t
    pad = [0, 0] * (t.ndim - 1 - dim) + [0, extra]
    return F.pad(t, pad)


def int8_matmul(x_q: torch.Tensor, w_q: torch.Tensor) -> torch.Tensor:
    """x_q [M, K] int8 @ w_q[N, K]^T int8 -> exact int32 [M, N].

    ``torch._int_mm`` with the weight as a column-major [K, N] view. Shapes
    it does not take on the card are zero-padded and the result cut back;
    there is no float fallback."""
    M, K = x_q.shape
    N = w_q.shape[0]
    if w_q.shape[1] != K:
        raise ValueError(f"int8_matmul: x {tuple(x_q.shape)} vs w {tuple(w_q.shape)}")
    Mp = max(M, _MIN_ROWS)
    Kp = -(-K // _ALIGN) * _ALIGN
    Np = -(-N // _ALIGN) * _ALIGN
    a = _pad_to(_pad_to(x_q, 1, Kp), 0, Mp).contiguous()
    b = _pad_to(_pad_to(w_q, 1, Kp), 0, Np).contiguous()
    acc = torch._int_mm(a, b.t())
    if (Mp, Np) != (M, N):
        acc = acc[:M, :N]
    return acc


def qlinear(
    x: torch.Tensor, w_q: torch.Tensor, w_scale: torch.Tensor,
    bias: torch.Tensor | None,
) -> torch.Tensor:
    """W8A8 linear: x [..., in] with int8 w_q [out, in] and fp32 per-output
    scales -> x.dtype [..., out]. Epilogue in fp32: acc * (s_x * s_w), plus
    the bias, then the cast."""
    lead = x.shape[:-1]
    x_q, s_x = dynamic_quant_rows(x.reshape(-1, x.shape[-1]))
    acc = int8_matmul(x_q, w_q)
    y = acc.float() * (s_x * w_scale.reshape(-1))
    if bias is not None:
        y = y + bias.float()
    return y.reshape(*lead, acc.shape[-1]).to(x.dtype)


class _Int8Weight(nn.Module):
    """An int8 weight [out, in] with fp32 per-output scales and an optional
    bias. The scales stay fp32 whatever dtype the model is cast to: they
    follow a ``.to()`` to its device only. The bias follows the model dtype,
    as the rest of the model's parameters do."""

    def __init__(self, w_q: torch.Tensor, scale: torch.Tensor,
                 bias: torch.Tensor | None):
        super().__init__()
        self.in_features = w_q.shape[1]
        self.out_features = w_q.shape[0]
        self.register_buffer("weight_q", w_q)
        self.register_buffer("scale", scale.float())
        self.register_buffer("bias", bias)

    @classmethod
    def from_linear(cls, lin: nn.Linear) -> "_Int8Weight":
        w_q, scale = quantize_weight(lin.weight.detach())
        bias = None if lin.bias is None else lin.bias.detach()
        return cls(w_q, scale, bias)

    @classmethod
    def empty(cls, d_in: int, d_out: int, bias: bool, device=None, dtype=None):
        """Uninitialized storage of the right shapes (checkpoint loading)."""
        return cls(
            torch.empty((d_out, d_in), dtype=torch.int8, device=device),
            torch.empty(d_out, dtype=torch.float32, device=device),
            torch.empty(d_out, dtype=dtype, device=device) if bias else None,
        )

    def _apply(self, fn, recurse=True):
        scale = self._buffers.pop("scale")
        super()._apply(fn, recurse)
        moved = fn(scale)  # [out] floats: the copy costs nothing
        if moved.dtype != scale.dtype:  # a dtype cast: keep fp32, move only
            moved = scale.to(moved.device)
        self.register_buffer("scale", moved)
        return self

    def extra_repr(self) -> str:
        return (f"in_features={self.in_features}, out_features={self.out_features}, "
                f"bias={self.bias is not None}")


class QLinear(_Int8Weight):
    """W8A8: int8 weights, per-row dynamic int8 activations, int32 GEMM."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return qlinear(x, self.weight_q, self.scale, self.bias)


class W8Linear(_Int8Weight):
    """W8A16: the int8 weight dequantizes into the activation dtype (the
    JAX package's ``kernel_w8`` form) and the matmul runs there; the
    activations carry no quantization error."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = self.weight_q.to(x.dtype) * self.scale.to(x.dtype)[:, None]
        y = x @ w.t()
        if self.bias is not None:
            y = y + self.bias.to(x.dtype)
        return y


# The six quantized linears of a block: (parent path inside the block, name)
QUANTIZED_LINEARS = (
    ("attn1", "to_q"), ("attn1", "to_k"), ("attn1", "to_v"),
    ("attn1.to_out", "0"), ("ff.net.0", "proj"), ("ff.net", "2"),
)


@torch.no_grad()
def quantize_dit(dit: nn.Module, w_only: bool = False) -> nn.Module:
    """Swap the hot linears of every DiT block for int8 ones, in place.

    W8A8 ``QLinear`` by default, W8A16 ``W8Linear`` with ``w_only``. Each
    bf16 linear is dropped as its int8 module replaces it, so quantizing on
    the card never holds a second full copy of the weights. Linears that
    are already int8 are left as they are."""
    cls = W8Linear if w_only else QLinear
    for block in dit.transformer_blocks:
        for parent_path, name in QUANTIZED_LINEARS:
            parent = block.get_submodule(parent_path)
            lin = parent.get_submodule(name)
            if isinstance(lin, _Int8Weight):
                if not isinstance(lin, cls):
                    raise ValueError(
                        f"{parent_path}.{name} is already {type(lin).__name__}, "
                        f"cannot requantize as {cls.__name__}")
                continue
            setattr(parent, name, cls.from_linear(lin))
            del lin
    return dit

