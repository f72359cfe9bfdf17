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

The VAE half (the int8 VAE serving modes ``int8``, ``int8-vae`` and
``int8-dit-dec``) is the counterpart of the rest of ``dove_tpu/ops/quant.py``:

  * activations: asymmetric per-tensor int8, ``x ~= s * x_q + m``, with a
    runtime search over twelve candidate grid ranges
    (``dynamic_quant_asym``) and an optional per-input-channel equalization
    folded into the quantizer (``equalize_inv``); the affine offset folds
    back exactly through the conv as ``m * kernel_scale * conv(1_valid,
    kernel_ksum)`` (``ksum_correction``), so the padded border holds the
    *code* 0;
  * weights: per-output-channel int8, optionally equalized
    (``equalization_vector``), searched (``quantize_weight(clip_search=)``)
    or rounded with tap-space error feedback (``gptq_tap_rounding``);
  * ``QConv3d`` holds a quantized conv: the codes in the layout of the conv
    kernel K4 (``ops/conv3d_int8.py``), fp32 ``kernel_scale``,
    ``kernel_ksum`` and ``equalize_inv``; ``quantize_vae`` swaps it in, in
    place, for every conv the policy ``should_quantize_conv`` selects, and
    ``qconv`` runs it: the range search here, then the quantizer's pack pass
    and K4 (``ops/conv3d_int8.py``) for the stride-1 convs (k_t = 3 and the
    per-frame k_t = 1 ones), K4 adding the offset term and the bias in its
    epilogue; for the encoder's three stride-2 convs one int8 matrix
    product over the nine strided views, which the JAX package also
    computes outside any hand-written kernel. No path converts int8 codes
    back to floats to convolve them.

Nothing here waits for the device: the chosen grid stays a pair of 0-d
tensors, and K4 reads its scale from device memory.
"""

from __future__ import annotations

import itertools
import math

import torch
import torch.nn.functional as F
from torch import nn
from torch.profiler import record_function

EPS = 1e-12
INV_127 = 1.0 / 127.0  # taken as fp32 by the tensor ops, as XLA folds it
INV_254 = 1.0 / 254.0
# torch._int_mm on the card takes more than 16 rows and inner and output
# sizes that are multiples of 8; the wrapper pads up to that with zeros,
# which leave the int32 products unchanged.
_MIN_ROWS = 17
_ALIGN = 8


def quantize_weight(
    w: torch.Tensor, clip_search: int = 0
) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-output-channel int8 of a torch-layout weight (the output
    channel first: a linear's [out, in], a conv's [O, I, k...]) -> (int8 of
    the same shape, fp32 scale [out]).

    clip_search > 0 searches that many geometrically spaced ratios in
    [0.3, 1.0] of each channel's amax for the scale with the least squared
    rounding error; 1.0 is among them, so it never does worse than amax."""
    wf = w.float()
    flat = wf.flatten(1)
    base = flat.abs().amax(dim=1).clamp_min(EPS) * INV_127
    scale = base
    if clip_search:
        ratios = torch.logspace(math.log10(0.3), 0.0, clip_search,
                                dtype=torch.float32, device=w.device)
        errs = []
        for r in ratios:  # one at a time: one fp32 copy of the kernel as temp
            s = (base * r)[:, None]
            q = torch.round(flat / s).clamp_(-127, 127)
            errs.append((q * s - flat).square_().sum(dim=1))
        scale = base * ratios[torch.stack(errs).argmin(dim=0)]
    shape = (-1,) + (1,) * (w.ndim - 1)
    w_q = torch.round(wf / scale.view(shape)).clamp_(-127, 127).to(torch.int8)
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


class _Fp32Buffers(nn.Module):
    """A module whose buffers named in ``_fp32_buffers`` stay fp32 whatever
    dtype the model is cast to: they follow a ``.to()`` to its device only."""

    _fp32_buffers: tuple[str, ...] = ()

    def _apply(self, fn, recurse=True):
        kept = {n: self._buffers.pop(n) for n in self._fp32_buffers
                if self._buffers.get(n) is not None}
        super()._apply(fn, recurse)
        for name, buf in kept.items():
            moved = fn(buf)  # per-channel floats: the copy costs nothing
            if moved.dtype != buf.dtype:  # a dtype cast: keep fp32, move only
                moved = buf.to(moved.device)
            self.register_buffer(name, moved)
        return self


class _Int8Weight(_Fp32Buffers):
    """An int8 weight [out, in] with fp32 per-output scales and an optional
    bias. The scales stay fp32 whatever dtype the model is cast to. The bias
    follows the model dtype, as the rest of the model's parameters do."""

    _fp32_buffers = ("scale",)

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



# ---------------------------------------------------------------------------
# The VAE half: asymmetric activations, equalized weights, QConv3d
# ---------------------------------------------------------------------------

_TAIL_CLIP_CANDIDATES = (0.2, 0.35, 0.5, 0.65, 0.8, 0.9, 1.0)
_SYM_CLIP_CANDIDATES = (0.2, 0.35, 0.5, 0.65, 0.8)
# the range search runs on 8 contiguous row segments (1/128 of the rows) of a
# tensor with at least this many rows (positions), on all of a smaller one
_SUBSAMPLE_ROWS = 1 << 15


def dynamic_quant(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-tensor int8 with a runtime scale (an fp32 0-d tensor)."""
    xf = x.float()
    scale = xf.abs().amax().clamp_min(EPS) * INV_127
    x_q = torch.round(xf / scale).clamp_(-127, 127).to(torch.int8)
    return x_q, scale


def _search_sample(x: torch.Tensor, channel_dim: int) -> tuple[torch.Tensor, tuple]:
    """The fp32 values the range search looks at, and the shape that lines a
    per-channel vector up with them. Rows are positions in (batch, frame,
    row, column) order with all their channels; a large tensor contributes 8
    contiguous row segments of n_rows // 1024 rows at multiples of n_rows //
    8, the JAX package's sample, whichever axis holds the channels."""
    channel_dim %= x.ndim
    C = x.shape[channel_dim]
    n_rows = x.numel() // C
    bshape = tuple(C if d == channel_dim else 1 for d in range(x.ndim))
    if n_rows < _SUBSAMPLE_ROWS:
        return x.float(), bshape
    seg_len = max(n_rows // 1024, 1)
    step = n_rows // 8
    if channel_dim == x.ndim - 1:
        x2 = x.reshape(n_rows, C)
        parts = [x2[i * step:i * step + seg_len] for i in range(8)]
        return torch.cat(parts).float(), (1, C)
    if channel_dim != 1:
        raise ValueError("channels must be the last axis or axis 1")
    xb = x.reshape(x.shape[0], C, -1)  # [B, C, positions of one item]
    per_item = xb.shape[2]
    parts = []
    for i in range(8):
        start, left = i * step, seg_len
        while left > 0:  # a segment may run over the end of a batch item
            b, r = divmod(start, per_item)
            take = min(left, per_item - r)
            parts.append(xb[b, :, r:r + take])
            start, left = start + take, left - take
    return torch.cat(parts, dim=1).float(), (C, 1)


def asym_grid(
    x: torch.Tensor, tail_clip: bool = True, eq_inv: torch.Tensor | None = None,
    channel_dim: int = -1, return_errors: bool = False,
):
    """The asymmetric grid of :func:`dynamic_quant_asym` -> (s, m), fp32 0-d
    tensors on x's device; with ``return_errors`` also the twelve candidates'
    squared errors."""
    e = None if eq_inv is None else eq_inv.float().reshape(-1)
    if not tail_clip:
        dims = tuple(d for d in range(x.ndim) if d != channel_dim % x.ndim)
        xf = x.float()
        if e is not None:
            amax = (xf.amax(dim=dims) * e).amax()
            amin = (xf.amin(dim=dims) * e).amin()
        else:
            amax, amin = xf.amax(), xf.amin()
        m = 0.5 * (amax + amin)
        s = ((amax - amin) * INV_254).clamp_min(EPS)
        return (s, m, None) if return_errors else (s, m)
    xs, bshape = _search_sample(x, channel_dim)
    if e is not None:
        xs = xs * e.view(bshape)
    amax, amin = xs.amax(), xs.amin()
    ct = torch.tensor(_TAIL_CLIP_CANDIDATES, dtype=torch.float32, device=x.device)
    cs = torch.tensor(_SYM_CLIP_CANDIDATES, dtype=torch.float32, device=x.device)
    a = torch.maximum(amax.abs(), amin.abs())
    lo = torch.cat([torch.ones_like(ct) * amin, -cs * a])
    hi = torch.cat([amin + ct * (amax - amin), cs * a])
    m_c = 0.5 * (hi + lo)
    s_c = ((hi - lo) * INV_254).clamp_min(EPS)
    # all twelve candidates at once: [12, 1] against the flat sample
    flat = xs.reshape(1, -1)
    sc, mc = s_c[:, None], m_c[:, None]
    q = torch.round((flat - mc) / sc).clamp_(-127, 127)
    errs = q.mul_(sc).add_(mc).sub_(flat).square_().sum(dim=1)
    # gathers by a one-element index tensor: indexing with a 0-d tensor would
    # read it back to the host, and no value leaves the device here
    best = errs.argmin().reshape(1)
    s, m = s_c.index_select(0, best).reshape(()), m_c.index_select(0, best).reshape(())
    return (s, m, errs) if return_errors else (s, m)


def asym_codes(
    x: torch.Tensor, s: torch.Tensor, m: torch.Tensor,
    eq_inv: torch.Tensor | None = None, channel_dim: int = -1,
    out: torch.Tensor | None = None,
) -> torch.Tensor:
    """int8 codes of x on the grid (s, m): round(x * (eq_inv / s) - m / s)
    with an equalization vector, round((x - m) / s) without, clipped to
    +-127. ``out`` (int8, x's shape, any strides) takes the codes in one
    strided copy, which is where the VAE changes layout.

    XLA compiles the equalized form into one fused multiply-add, so the
    product is not rounded before the subtraction. The port keeps that: on
    the card ``torch.addcmul`` is compiled the same way, and on the CPU the
    product is taken in float64, where it is exact."""
    if eq_inv is not None:
        shape = tuple(-1 if d == channel_dim % x.ndim else 1 for d in range(x.ndim))
        mult = (eq_inv.float().reshape(-1) / s).view(shape)
        if x.device.type == "cpu":
            xf = (x.double() * mult.double() - (m / s).double()).float()
        else:
            xf = torch.addcmul(-(m / s), x.float(), mult)
    else:
        xf = x.float()
        if xf is x:
            xf = x.clone()
        xf.sub_(m).div_(s)
    xf.round_().clamp_(-127, 127)
    if out is None:
        return xf.to(torch.int8)
    return out.copy_(xf)


def dynamic_quant_asym(
    x: torch.Tensor, tail_clip: bool = True, eq_inv: torch.Tensor | None = None,
    channel_dim: int = -1,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Asymmetric per-tensor int8: x ~= s * x_q + m (s, m fp32 0-d tensors).

    ``tail_clip`` picks (s, m) by the least squared error among two families
    of grid ranges: lo = amin with hi = amin + c (amax - amin) for SiLU-shaped
    inputs, and +-c max(|amin|, |amax|) for zero-centred ones; c = 1.0 is
    among them. Values outside the range saturate. Extrema and errors are
    taken on a sample of a large tensor (see ``_search_sample``). ``eq_inv``
    (per input channel, positive) folds an equalization pre-scale into the
    quantizer: the result quantizes ``x * eq_inv``."""
    s, m = asym_grid(x, tail_clip, eq_inv, channel_dim)
    return asym_codes(x, s, m, eq_inv, channel_dim), s, m


def gptq_tap_rounding(
    w: torch.Tensor, scale: torch.Tensor, tapcorr: torch.Tensor,
    damp: float = 0.01,
) -> torch.Tensor:
    """GPTQ error-feedback rounding along the tap axis (the JAX package's
    ``gptq_tap_rounding``). w: fp32 ``[(*k), cin, cout]`` (the JAX kernel
    layout), scale ``[cout]``, tapcorr ``[2r+1, 2r+1, 2r+1]`` -> int8 of w's
    shape. One Hessian H[t, t'] = c(delta_t - delta_t') serves every (cin,
    cout) column; after rounding tap t the later taps absorb the residual
    along row t of the upper Cholesky factor of H^-1. Per column the result
    is kept only where its expected output error delta^T H0 delta beats
    round-to-nearest's. H0 is used undamped there, as in the JAX package."""
    k_dims = tuple(w.shape[:-2])
    taps = list(itertools.product(*[range(k) for k in k_dims]))
    T = len(taps)
    r = (tapcorr.shape[0] - 1) // 2
    c = tapcorr.float()
    idx = []
    for ti in taps:
        for tj in taps:
            d = [a - b for a, b in zip(ti, tj)]
            d = [0] * (3 - len(d)) + d  # 2D kernels: temporal offset 0
            idx.append((d[0] + r, d[1] + r, d[2] + r))
    i0, i1, i2 = (torch.tensor(v, device=w.device) for v in zip(*idx))
    H0 = c[i0, i1, i2].reshape(T, T)
    H = H0 + damp * torch.eye(T, dtype=torch.float32, device=w.device)
    # an estimate of H from a small window can be indefinite: then, as
    # jnp.linalg.cholesky does, the factor is NaN, every column's GPTQ error
    # is NaN and round-to-nearest is kept
    L, info = torch.linalg.cholesky_ex(torch.linalg.inv(H))
    U = torch.where(info == 0, L, torch.full_like(L, float("nan"))).T

    W0 = w.float().reshape((T,) + tuple(w.shape[-2:]))
    W2 = W0.clone()
    s = scale.reshape(1, -1)
    q_rows = []
    for t in range(T):
        q = torch.round(W2[t] / s).clamp_(-127, 127)
        q_rows.append(q)
        if t + 1 < T:
            err = (W2[t] - q * s) / U[t, t]
            W2[t + 1:] += -U[t, t + 1:].reshape(-1, 1, 1) * err[None]
    q_gptq = torch.stack(q_rows)
    q_rtn = torch.round(W0 / s).clamp_(-127, 127)
    d_g = q_gptq * s - W0
    d_r = q_rtn * s - W0
    e_g = torch.einsum("tij,ts,sij->ij", d_g, H0, d_g)
    e_r = torch.einsum("tij,ts,sij->ij", d_r, H0, d_r)
    w_q = torch.where((e_g < e_r)[None], q_gptq, q_rtn)
    return w_q.to(torch.int8).reshape(w.shape)


def ksum_classes(
    kernel_ksum: torch.Tensor, height: int, width: int, padding: int,
) -> torch.Tensor:
    """conv(1_valid, kernel_ksum), the geometry factor of the affine offset's
    term, by border class -> fp32 ``[Cout, min(H, 3), min(W, 3)]`` (``[Cout,
    1, 1]`` without padding).

    kernel_ksum: fp32 ``[Cout, 1, kt, 3, 3]``. Every frame of the input holds
    data (the causal frames are real frames), so the factor does not depend
    on the frame. Without spatial padding every output sees the whole
    kernel; with the one-pixel zero border the first and last row and column
    see only the taps inside the image, and every other one the whole
    kernel, so a 3x3 conv of ones gives the nine classes. The sums are
    integers below 2^24, taken in float64 and exact in fp32 (a TF32
    convolution would round them)."""
    if padding == 0:
        return kernel_ksum.sum(dim=(1, 2, 3, 4)).view(-1, 1, 1)
    if padding != 1:
        raise ValueError(f"padding {padding}: the VAE's convs pad by 0 or 1")
    kt = kernel_ksum.shape[2]
    ones = torch.ones((1, 1, kt, min(height, 3), min(width, 3)), dtype=torch.float64,
                      device=kernel_ksum.device)
    return F.conv3d(ones, kernel_ksum.double(), padding=(0, 1, 1)).float()[0, :, 0]


def ksum_correction(
    kernel_ksum: torch.Tensor, height: int, width: int, padding: int,
) -> torch.Tensor:
    """:func:`ksum_classes` laid out over the image -> fp32 ``[1, Cout, 1,
    Ho, Wo]`` (``[1, Cout, 1, 1, 1]`` without padding), to broadcast over
    batch and frames."""
    from dove_tpu_torch.ops.conv3d_int8 import expand_classes

    small = ksum_classes(kernel_ksum, height, width, padding)
    if padding:
        small = expand_classes(small, height, width)
    return small[None, :, None]


def equalize_input(conv: "QConv3d", x: torch.Tensor, channel_dim: int = -1) -> torch.Tensor:
    """x times the conv's per-channel equalization in fp32 (x itself when
    the conv has none): the symmetric path's pre-scale."""
    if conv.equalize_inv is None:
        return x
    shape = tuple(-1 if d == channel_dim % x.ndim else 1 for d in range(x.ndim))
    return x.float() * conv.equalize_inv.view(shape)


def equalization_vector(
    w: torch.Tensor, calib_amax: torch.Tensor, alpha: float = 0.5
) -> torch.Tensor:
    """SmoothQuant-style per-input-channel equalization d [cin] of a
    torch-layout conv weight ``[O, I, k...]``: x / d quantizes, w * d absorbs
    it. d = amax_x^alpha / amax_w^(1 - alpha), normalized to geometric mean
    1 and clipped to [2^-6, 2^6]; channels with no observed range keep 1."""
    dims = tuple(d for d in range(w.ndim) if d != 1)
    a_w = w.float().abs().amax(dim=dims)
    a_x = calib_amax.float().to(w.device)
    ok = (a_x > 0) & (a_w > 0)
    d = torch.where(
        ok,
        a_x.clamp_min(1e-12).pow(alpha) / a_w.clamp_min(1e-12).pow(1.0 - alpha),
        torch.ones_like(a_x),
    )
    logd = d.log()
    mean = torch.where(ok, logd, torch.zeros_like(logd)).sum() / ok.sum()
    d = (logd - mean).exp()
    return torch.where(ok, d, torch.ones_like(d)).clamp(2.0**-6, 2.0**6)


class QConv3d(_Fp32Buffers):
    """A quantized 3x3 (x k_t) conv of the VAE: int8 ``weight_q`` in K4's
    ``[kt * 9, Cout, Cin]`` layout, fp32 ``kernel_scale [Cout]``, the
    asymmetric scheme's ``kernel_ksum [Cout, 1, kt, 3, 3]`` (the codes summed
    over the input channels; None selects symmetric activations),
    ``equalize_inv [Cin]`` (None without calibration) and the bias in the
    model dtype. It stands where the ``nn.Conv3d`` or ``nn.Conv2d`` stood and
    is run by :func:`qconv`. ``backend = "plain"`` makes it take K4's plain
    version on any device (for comparisons)."""

    _fp32_buffers = ("kernel_scale", "kernel_ksum", "equalize_inv")

    def __init__(self, weight_q, kernel_scale, kernel_ksum, equalize_inv, bias):
        super().__init__()
        taps, self.out_channels, self.in_channels = weight_q.shape
        self.kt = taps // 9
        self.backend: str | None = None
        self.register_buffer("weight_q", weight_q)
        self.register_buffer("kernel_scale", kernel_scale.float())
        self.register_buffer("kernel_ksum", kernel_ksum)
        self.register_buffer("equalize_inv", equalize_inv)
        self.register_buffer("bias", bias)

    @classmethod
    def empty(cls, cin: int, cout: int, kt: int, ksum: bool, equalized: bool,
              bias: bool, device=None, dtype=None) -> "QConv3d":
        """Uninitialized storage of the right shapes (checkpoint loading)."""
        def f32(*shape):
            return torch.empty(shape, dtype=torch.float32, device=device)

        return cls(
            torch.empty((kt * 9, cout, cin), dtype=torch.int8, device=device),
            f32(cout), f32(cout, 1, kt, 3, 3) if ksum else None,
            f32(cin) if equalized else None,
            torch.empty(cout, dtype=dtype, device=device) if bias else None,
        )

    def extra_repr(self) -> str:
        return (f"{self.in_channels}, {self.out_channels}, kt={self.kt}, "
                f"asymmetric={self.kernel_ksum is not None}, "
                f"equalized={self.equalize_inv is not None}")


@torch.no_grad()
def quantize_conv(
    conv: nn.Conv3d | nn.Conv2d, with_ksum: bool = False,
    calib_amax: torch.Tensor | None = None, clip_search: int = 0,
    tapcorr: torch.Tensor | None = None,
) -> QConv3d:
    """The conv half of the JAX package's ``_quantize_leaf_dict``: a float
    conv -> its :class:`QConv3d`.

    calib_amax (per-input-channel activation amax from ``vae.calibrate``)
    folds the equalization d into the weights in fp32 and stores
    ``equalize_inv`` = 1 / d. tapcorr (the calibrated input autocorrelation)
    rounds with :func:`gptq_tap_rounding` on the plain amax scales; otherwise
    :func:`quantize_weight` rounds to nearest, with ``clip_search``.
    ``kernel_ksum`` comes from the final codes, so the correction stays
    consistent with them."""
    from dove_tpu_torch.ops.conv3d_int8 import pack_taps

    w = conv.weight.detach()
    eq_inv = None
    if calib_amax is not None:
        d = equalization_vector(w, calib_amax)
        w = w.float() * d.view((1, -1) + (1,) * (w.ndim - 2))
        eq_inv = 1.0 / d
    to_jax = (2, 3, 4, 1, 0) if w.ndim == 5 else (2, 3, 1, 0)
    if tapcorr is not None:
        wf = w.float()
        scale = wf.flatten(1).abs().amax(dim=1).clamp_min(EPS) / 127.0
        w_q = gptq_tap_rounding(wf.permute(to_jax), scale,
                                torch.as_tensor(tapcorr, device=w.device))
    else:
        w_q, scale = quantize_weight(w, clip_search)
        w_q = w_q.permute(to_jax)
    packed = pack_taps(w_q)  # [(kt,) 3, 3, Cin, Cout] -> [taps, Cout, Cin]
    cout = packed.shape[1]
    kt = packed.shape[0] // 9
    ksum = None
    if with_ksum:
        ksum = packed.float().sum(dim=2).T.reshape(cout, 1, kt, 3, 3).contiguous()
    bias = None if conv.bias is None else conv.bias.detach()
    return QConv3d(packed, scale, ksum, eq_inv, bias)


def qconv(conv: QConv3d, x: torch.Tensor, stride: int = 1, padding: int = 1) -> torch.Tensor:
    """The int8 convolution of NCDHW ``x [B, Cin, F, H, W]`` -> ``[B, Cout,
    Fo, Ho, Wo]`` in x's dtype; the temporal axis is VALID (the caller has
    prepended the causal frames), the spatial axes take ``stride`` and a
    zero ``padding``.

    After the range search the quantizer reads x once more
    (``ops/conv3d_int8.quantize_pack``) and writes the codes channels-last
    with the spatial border in place: the border is the code 0, which the
    ksum term makes exactly real 0. Stride 1 with padding 1 is K4
    (``ops/conv3d_int8.conv_taps``), writing NCDHW in x's dtype; stride 2
    without padding (the encoder's downsamplers, padded by their caller) is
    one int8 matrix product over the nine strided views. Either way, in fp32
    and in the JAX package's order: ``acc * (s * kernel_scale)``, plus
    ``(m * kernel_scale) * conv(1_valid, kernel_ksum)``, plus the bias, and
    one cast; K4 does these steps in its epilogue."""
    from dove_tpu_torch.ops import conv3d_int8

    if (stride, padding) not in ((1, 1), (2, 0)):
        raise ValueError(f"qconv runs stride 1 with padding 1 or stride 2 with "
                         f"padding 0, not stride {stride}, padding {padding}")
    B, C, Ft, H, W = x.shape
    if C != conv.in_channels:
        raise ValueError(f"x has {C} channels, the conv takes {conv.in_channels}")
    plain = conv.backend == "plain"
    with record_function("dove.qconv.quantize"):
        if conv.kernel_ksum is not None:
            s, m = asym_grid(x, eq_inv=conv.equalize_inv, channel_dim=1)
            x_q = conv3d_int8.quantize_pack(x, s, m, conv.equalize_inv, padding, plain)
            addend = ((m * conv.kernel_scale).view(-1, 1, 1)
                      * ksum_classes(conv.kernel_ksum, H, W, padding)).contiguous()
        else:
            codes, s = dynamic_quant(equalize_input(conv, x, channel_dim=1))
            x_q = F.pad(codes.permute(0, 2, 3, 4, 1), (0, 0) + (padding,) * 4)
            addend = None
        scale = s * conv.kernel_scale
        bias = None if conv.bias is None else conv.bias.float()
    if stride == 1:
        return conv3d_int8.conv_taps(x_q, conv.weight_q, scale, conv.kt, x.dtype,
                                     channels_first=True, plain=plain,
                                     addend=addend, bias=bias)
    Ho, Wo = (H - 3) // 2 + 1, (W - 3) // 2 + 1
    Fo = Ft - (conv.kt - 1)
    cols = torch.cat([
        x_q[:, dt:dt + Fo, dh:dh + 2 * Ho - 1:2, dw:dw + 2 * Wo - 1:2]
        for dt in range(conv.kt) for dh in range(3) for dw in range(3)
    ], dim=-1).reshape(-1, conv.kt * 9 * C)
    del x_q
    w2 = conv.weight_q.permute(1, 0, 2).reshape(conv.out_channels, -1)
    y = int8_matmul(cols, w2).float() * scale  # [B * Fo * Ho * Wo, Cout]
    if addend is not None:
        y += addend.view(-1)
    if bias is not None:
        y += bias
    return y.to(x.dtype).reshape(B, Fo, Ho, Wo, -1).permute(0, 4, 1, 2, 3).contiguous()


# ---------------------------------------------------------------------------
# Which convs, under which names
# ---------------------------------------------------------------------------

def calib_name(path: tuple) -> str:
    """A JAX VAE param-tree path -> the runtime conv name the calibration and
    attribution taps use (the conv-cache keys under a scope):
      ("decoder","up_blocks",0,"resnets",1,"conv1") -> "decoder.up.0.res.1.conv1"
      ("decoder","mid_block","resnets",0,"conv2")   -> "decoder.mid.0.conv2"
      ("encoder","down_blocks",2,"downsampler","conv") -> "encoder.down.2.downsample"
    """
    out: list[str] = []
    toks = list(path)
    i = 0
    while i < len(toks):
        t = toks[i]
        if t == "down_blocks":
            out.append("down")
        elif t == "up_blocks":
            out.append("up")
        elif t == "mid_block":
            out.append("mid")
            if i + 1 < len(toks) and toks[i + 1] == "resnets":
                i += 1  # cache keys use "mid.{j}", not "mid.res.{j}"
        elif t == "resnets":
            out.append("res")
        elif t in ("downsampler", "upsampler"):
            out.append(t.replace("sampler", "sample"))
            if i + 1 < len(toks) and toks[i + 1] == "conv":
                i += 1  # the leaf dict key "conv" is not in the name
        else:
            out.append(str(t))
        i += 1
    return ".".join(out)


def module_calib_name(module_path: str) -> str:
    """The port's module path of a conv -> its runtime name:
      "decoder.up_blocks.0.resnets.1.conv1.conv" -> "decoder.up.0.res.1.conv1"
      "encoder.down_blocks.2.downsamplers.0.conv" -> "encoder.down.2.downsample"
    by way of the JAX tree path that :func:`calib_name` takes."""
    toks = module_path.split(".")
    path: list = []
    i = 0
    while i < len(toks):
        t = toks[i]
        if t in ("downsamplers", "upsamplers"):
            path += [t[:-1], "conv"]  # ".0.conv" is the JAX tree's ["conv"]
            i += 3
            continue
        if t == "conv" and i == len(toks) - 1:
            break  # a CausalConv3d's inner nn.Conv3d
        path.append(int(t) if t.isdigit() else t)
        i += 1
    return calib_name(tuple(path))


def should_quantize_conv(w: torch.Tensor) -> bool:
    """The VAE conv quantization policy, on a torch-layout weight ``[O, I,
    (kt,) kh, kw]``: spatial kernel >= 3x3 and >= 64 channels on both sides.
    conv_in, conv_out, the 1x1x1 modulation convs and the shortcuts stay in
    the model dtype."""
    if getattr(w, "ndim", 0) not in (4, 5):
        return False
    cout, cin = w.shape[:2]
    kh, kw = w.shape[-2:]
    return kh >= 3 and kw >= 3 and cin >= 64 and cout >= 64


def quantizable_convs(vae: nn.Module, which: str = "all"):
    """(runtime name, module path, parent module, attribute, conv) of every
    float conv the policy selects, in ``which`` half of the VAE."""
    if which not in ("all", "decoder", "encoder"):
        raise ValueError(f"which={which!r}")
    found = []
    for path, mod in vae.named_modules():
        if which != "all" and path != which and not path.startswith(which + "."):
            continue
        for attr, child in mod.named_children():
            if (isinstance(child, (nn.Conv3d, nn.Conv2d))
                    and should_quantize_conv(child.weight)):
                full = f"{path}.{attr}"
                found.append((module_calib_name(full), full, mod, attr, child))
    return found


def synthetic_vae_calib(vae: nn.Module) -> dict[str, torch.Tensor]:
    """Unit activation-amax stats for every quantizable VAE conv: for speed
    measurement only. Every matched conv then carries ``equalize_inv`` and
    pays the runtime per-channel pre-scale, as with a real calibration."""
    return {name: torch.ones(conv.in_channels, dtype=torch.float32)
            for name, _, _, _, conv in quantizable_convs(vae)}


def lowres_decoder_exclusions(vae: nn.Module) -> tuple[str, ...]:
    """The mixed-precision exclusion set the literal name "lowres" stands
    for: every quantizable decoder conv below the two full-resolution up
    levels (mid and up.0 .. up.{n-3}), by runtime name, sorted."""
    n_up = len(vae.decoder.up_blocks)
    low = ("decoder.mid",) + tuple(f"decoder.up.{i}." for i in range(max(n_up - 2, 0)))
    return tuple(sorted(
        name for name, *_ in quantizable_convs(vae, "decoder")
        if name.startswith(low)))


@torch.no_grad()
def quantize_vae(
    vae: nn.Module, which: str = "all", calib: dict | None = None,
    exclude: tuple[str, ...] | list[str] | None = None, weight_clip: int = 0,
) -> nn.Module:
    """Swap the VAE's hot convs (policy: :func:`should_quantize_conv`) for
    :class:`QConv3d`s, in place, with asymmetric activations.

    which: "all" | "decoder" | "encoder" ("decoder" is the int8-dit-dec
    mode's half). calib: {name: per-input-channel activation amax, and
    optionally name + "#tapcorr": autocorrelation} from ``vae.calibrate``:
    a conv with an entry is equalized (and GPTQ-rounded with a tapcorr).
    exclude: runtime names to keep in the model dtype; an unknown name
    raises. weight_clip: candidate count of the weight scale search."""
    convs = quantizable_convs(vae, which)
    seen = {name for name, *_ in convs}
    unknown = set(exclude or ()) - seen
    if unknown:
        raise ValueError(
            f"exclude names not found among quantizable convs in "
            f"which={which!r}: {sorted(unknown)}; known: {sorted(seen)}")
    for name, _, parent, attr, conv in convs:
        if name in (exclude or ()):
            continue
        amax = calib.get(name) if calib else None
        tapcorr = calib.get(f"{name}#tapcorr") if calib else None
        setattr(parent, attr, quantize_conv(
            conv, with_ksum=True,
            calib_amax=None if amax is None else torch.as_tensor(amax),
            clip_search=weight_clip,
            tapcorr=None if tapcorr is None else torch.as_tensor(tapcorr)))
    return vae
