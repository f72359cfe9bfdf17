"""K4 and K5: the 3x3x3 tap convolution, one hand-written CUDA kernel family.

Counterpart of ``dove_tpu/ops/pallas/conv3d_int8.py``. ``conv3d_w8a8`` (K4)
and ``conv3d_bf16`` (K5) keep the JAX signatures and semantics: a VALID
3x3x3 convolution of a pre-padded channels-last input ``[F = Fo + 2,
Hp = Ho + 2, Wp = Wo + 2, Cin]`` (the caller prepends the two causal cache
frames and the spatial border) against ``[3, 3, 3, Cin, Cout]`` weights ->
``[Fo, Ho, Wo, Cout]``. K4 multiplies int8 codes, sums all 27 taps in int32
(exact), then takes ``float(acc) * (sx * sk[cout])`` in fp32 and rounds once
to ``out_dtype`` (bf16, fp16 or fp32). K5 multiplies bf16 operands (in an
fp16 VAE too, as the JAX package's ``conv3d_bf16`` does) and sums in fp32. The JAX
functions' ``row_block`` and ``dh_fold`` arguments pick among TPU schedules
of the same function, not among results, so they have no counterpart here.

Both are instantiations of one kernel in ``csrc/conv3d_taps_sm90.cu``, whose
note says what bounds it on the H100 and how its schedule differs from the
TPU's. Its tiling is planned here too (:func:`tile_count`, :func:`halo_boxes`,
:func:`tile_stores`, :func:`tap_row`), so that the CPU tests can check that
the plan stores every output once and reads nothing outside x, and so is the
weights' shared-memory image (:func:`weight_image`); the wrapper holds the
library's own numbers to these at first load.
:func:`conv_taps` is the form the VAE calls: a batch of windows, weights
already in the packed ``[taps, Cout, Cin]`` layout (:func:`pack_taps`,
done once when a conv is quantized), k_t = 3 or 1 (the per-frame 3x3 convs
of the upsamplers), the output written NCDHW if asked, and for K4 the rest
of the VAE's int8 conv in the epilogue: the asymmetric grid's offset term
(``addend``, per output channel and border class of the pixel) and the bias,
added in fp32 before the one rounding. On a CUDA tensor it launches the
kernel or raises; on a CPU tensor, or when the caller asks for ``plain``,
it runs :func:`conv_taps_plain`, the same arithmetic tap by tap in PyTorch.
There is no fallback from one to the other.

:func:`quantize_pack` is the step before K4: the activation quantizer's
last pass, NCDHW activation in, int8 codes out, channels-last with the
conv's zero border in place. ``csrc/conv3d_taps.cu`` holds its kernel
(``quant_pack_kernel``), and ``ops.quant.asym_codes`` into a zeroed buffer is
its plain version.

Launches are counted per kernel (``launches_w8a8`` for K4 at k_t = 3,
``launches_w8a8_kt1`` for K4 at k_t = 1, ``launches_bf16`` for K5,
``launches_quantize`` for the quantizer).
"""

from __future__ import annotations

import ctypes

import torch

from dove_tpu_torch import kernels
from dove_tpu_torch.obs import LaunchCounter
from dove_tpu_torch.ops.quant import asym_codes, int8_matmul

launches_w8a8 = LaunchCounter()  # K4, k_t = 3
launches_w8a8_kt1 = LaunchCounter()  # K4, k_t = 1 (per-frame 3x3 convs)
launches_bf16 = LaunchCounter()  # K5
launches_quantize = LaunchCounter()  # the quantizer's pack pass
# set to a list to have every launch append (x.shape, Cout, kt): the shapes a
# run gave the kernel
shape_log: list | None = None

# what the kernel takes: whole 64-channel input slabs, 128-wide cout blocks
CIN_MULTIPLE = 64
COUT_MULTIPLE = 128
# the output types of K4's and K5's epilogue (a bf16 or fp16 VAE, or fp32),
# by their code in the C entries; the quantizer's pass reads the same codes
OUT_TYPES = {torch.bfloat16: 0, torch.float32: 1, torch.float16: 2}
QUANT_INPUT_TYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


# The CUDA kernel's tiling. Output positions are numbered over the padded
# frame, q = f * Hp * Wp + h * Wp + w, so that each tap of a run of positions
# is the same run of input rows shifted; a CTA owns TILE_M consecutive q (by
# 128 couts) of one window. For each (dt, dh) the CTA loads the PIECE_ROWS
# input rows from q0 + dt * Hp * Wp + dh * Wp on, as PIECE_ROWS // BOX_ROWS
# boxes; rows past the window read as zeros. Tap (dh, dw) of the tile's
# 64-row block j reads piece dh from row j * 64 + dw (:func:`tap_row`). A
# stage is one 32-byte slab of input channels; its weights arrive as one
# block of the image :func:`weight_image` lays out.
TILE_M = 384
PIECE_ROWS = 400
BOX_ROWS = 200
SLAB_BYTES = 32


def kernel_supports(cin: int, cout: int) -> bool:
    return cin % CIN_MULTIPLE == 0 and cout % COUT_MULTIPLE == 0


def flat_positions(Fo: int, Ho: int, Wo: int) -> int:
    """Flat positions a window's tiles must cover: up to the last stored one."""
    Hp, Wp = Ho + 2, Wo + 2
    return (Fo - 1) * Hp * Wp + (Ho - 1) * Wp + Wo


def tile_count(Fo: int, Ho: int, Wo: int) -> int:
    """CTAs along a window's positions (the grid's x)."""
    return -(-flat_positions(Fo, Ho, Wo) // TILE_M)


def halo_boxes(tile: int, kt: int, Ho: int, Wo: int) -> list[tuple[int, int, int]]:
    """(dt, dh, first input row) of every halo box a tile loads, in the
    window's flat input rows [F * Hp * Wp]; each box is BOX_ROWS rows."""
    Hp, Wp = Ho + 2, Wo + 2
    return [(dt, dh, tile * TILE_M + dt * Hp * Wp + dh * Wp + k * BOX_ROWS)
            for dt in range(kt) for dh in range(3)
            for k in range(PIECE_ROWS // BOX_ROWS)]


def tap_row(block: int, dw: int) -> int:
    """Row of a dh piece where tap (dh, dw) of 64-row block ``block`` starts."""
    return block * 64 + dw


def tile_stores(tile: int, Fo: int, Ho: int, Wo: int) -> tuple[torch.Tensor, ...]:
    """(row in the tile, f, h, w) of each position the tile stores: those
    with f < Fo, h < Ho and w < Wo."""
    Hp, Wp = Ho + 2, Wo + 2
    rows = torch.arange(TILE_M)
    q = tile * TILE_M + rows
    f, rem = q // (Hp * Wp), q % (Hp * Wp)
    h, w = rem // Wp, rem % Wp
    keep = (f < Fo) & (h < Ho) & (w < Wo)
    return rows[keep], f[keep], h[keep], w[keep]


def weight_image(w_packed: torch.Tensor) -> torch.Tensor:
    """Packed weights ``[kt * 9, Cout, Cin]`` (int8 or bf16) -> the kernel's
    shared-memory image, bytes ``[Cout / 128, kt, slabs, 9 taps, 128 cout,
    32]``: one contiguous block per stage (cout block, k_t, 32-byte slab of
    input channels), each tap's ``[128 cout, 32 B]`` tile in the 32-byte
    swizzle, whose two 16-byte halves trade places in rows 4-7 of every 8."""
    taps, cout, _ = w_packed.shape
    raw = w_packed.contiguous().view(torch.uint8)  # [taps, Cout, Cin bytes]
    kt, nb, slabs = taps // 9, cout // COUT_MULTIPLE, raw.shape[-1] // SLAB_BYTES
    img = raw.reshape(kt, 9, nb, COUT_MULTIPLE, slabs, SLAB_BYTES).permute(2, 0, 4, 1, 3, 5)
    # a tile's rows as [groups of 8][rows 0-3 or 4-7][4][two 16-byte halves][16]
    img = img.reshape(nb, kt, slabs, 9, COUT_MULTIPLE // 8, 2, 4, 2, 16)
    return torch.cat((img[:, :, :, :, :, :1], img[:, :, :, :, :, 1:].flip(-2)),
                     dim=5).reshape(-1)


def _check_geometry(lib: ctypes.CDLL) -> None:
    got = (ctypes.c_int * 4)()
    lib.dove_conv3d_sm90_geometry(got)
    want = (TILE_M, PIECE_ROWS, BOX_ROWS, 9 * COUT_MULTIPLE * SLAB_BYTES)
    if tuple(got) != want:
        raise RuntimeError(f"conv3d_taps_sm90 tiles as {tuple(got)}, the host's plan "
                           f"as {want}: rebuild or correct the plan")


def _library() -> ctypes.CDLL:
    lib = kernels.load("conv3d_taps_sm90")
    if lib.dove_conv3d_w8a8.argtypes is None:
        _check_geometry(lib)
        strides = [ctypes.c_longlong] * 5 + [ctypes.c_void_p]
        lib.dove_conv3d_w8a8.argtypes = (
            [ctypes.c_void_p] * 6 + [ctypes.c_int] * 10 + strides)
        lib.dove_conv3d_bf16.argtypes = (
            [ctypes.c_void_p] * 3 + [ctypes.c_int] * 8 + strides)
        for fn in (lib.dove_conv3d_w8a8, lib.dove_conv3d_bf16):
            fn.restype = ctypes.c_int
    return lib


def _quant_library() -> ctypes.CDLL:
    lib = kernels.load("conv3d_taps")
    if lib.dove_quant_pack.argtypes is None:
        lib.dove_quant_pack.argtypes = (
            [ctypes.c_void_p] * 6 + [ctypes.c_int] * 7 + [ctypes.c_void_p])
        lib.dove_quant_pack.restype = ctypes.c_int
    return lib


def pack_taps(w: torch.Tensor) -> torch.Tensor:
    """Weights ``[kt, 3, 3, Cin, Cout]`` (or ``[3, 3, Cin, Cout]``, k_t = 1)
    -> the packed layout ``[kt * 9, Cout, Cin]``, contiguous: tap-major in
    (kt, dh, dw) order, the input channel fastest, so that a tap's
    ``[Cout, Cin]`` slice is the B operand of its matrix product (the kernel
    reads it as :func:`weight_image` lays it out)."""
    if w.shape[-4:-2] != (3, 3) or w.ndim not in (4, 5):
        raise ValueError(f"expected [kt, 3, 3, Cin, Cout] weights, got {tuple(w.shape)}")
    cin, cout = w.shape[-2:]
    return w.reshape(-1, cin, cout).transpose(1, 2).contiguous()


def _out_shape(x: torch.Tensor, w_packed: torch.Tensor, kt: int):
    if x.ndim != 5 or w_packed.ndim != 3:
        raise ValueError(
            f"x must be [B, F, Hp, Wp, Cin] and w [taps, Cout, Cin], got "
            f"{tuple(x.shape)} and {tuple(w_packed.shape)}")
    B, F, Hp, Wp, cin = x.shape
    taps, cout, w_cin = w_packed.shape
    if kt not in (1, 3) or taps != kt * 9 or w_cin != cin:
        raise ValueError(
            f"k_t={kt}: x {tuple(x.shape)} does not go with w {tuple(w_packed.shape)}")
    Fo, Ho, Wo = F - (kt - 1), Hp - 2, Wp - 2
    if Fo < 1 or Ho < 1 or Wo < 1:
        raise ValueError(
            f"x {tuple(x.shape)} must hold the {kt - 1} causal cache frames and "
            "the one-pixel spatial border")
    return B, Fo, Ho, Wo, cin, cout


def border_classes(n: int, n_classes: int, device=None) -> torch.Tensor:
    """Index of each of n rows (or columns) into its border class: 0 for the
    first, 1 for the inner ones, ``n_classes - 1`` for the last, where
    ``n_classes = min(n, 3)``."""
    idx = torch.arange(n, device=device).clamp_(max=1)
    idx[-1] = n_classes - 1
    return idx


def expand_classes(small: torch.Tensor, height: int, width: int) -> torch.Tensor:
    """``[..., min(H, 3), min(W, 3)]`` per-class values -> the ``[..., H, W]``
    map, by two gathers."""
    hs, ws = small.shape[-2:]
    if (hs, ws) != (min(height, 3), min(width, 3)):
        raise ValueError(f"{tuple(small.shape)} does not hold the border classes "
                         f"of a {height}x{width} image")
    rows = border_classes(height, hs, small.device)
    cols = border_classes(width, ws, small.device)
    return small.index_select(-2, rows).index_select(-1, cols)


def _check_epilogue(quantized, addend, bias, cout, Ho, Wo):
    if not quantized and (addend is not None or bias is not None):
        raise ValueError("K5 takes no addend and no bias")
    if addend is not None and (addend.dtype != torch.float32 or addend.shape != (
            cout, min(Ho, 3), min(Wo, 3))):
        raise ValueError(f"addend must be fp32 [Cout, min(Ho, 3), min(Wo, 3)], got "
                         f"{addend.dtype} {tuple(addend.shape)}")
    if bias is not None and (bias.dtype != torch.float32 or bias.shape != (cout,)):
        raise ValueError(f"bias must be fp32 [Cout], got {bias.dtype} {tuple(bias.shape)}")


def conv_taps_plain(
    x: torch.Tensor, w_packed: torch.Tensor, scale: torch.Tensor | None,
    kt: int = 3, out_dtype: torch.dtype = torch.bfloat16,
    channels_first: bool = False, skip_tap: int | None = None,
    addend: torch.Tensor | None = None, bias: torch.Tensor | None = None,
) -> torch.Tensor:
    """The kernel's arithmetic step by step: for each of the kt * 9 taps the
    shifted view ``[B * Fo * Ho * Wo, Cin]`` times that tap's ``[Cin, Cout]``.
    int8 operands multiply through ``torch._int_mm`` and sum in int32, then
    ``float(acc) * scale`` in fp32, plus ``addend`` (``[Cout, min(Ho, 3),
    min(Wo, 3)]``, by the pixel's border class), plus ``bias``, each a
    rounded fp32 step; float operands are rounded to bf16 as K5 does,
    multiplied in fp32 and summed in fp32. One rounding to ``out_dtype``.
    ``skip_tap`` leaves one tap out (a deliberately wrong result, for
    checking that a comparison can fail)."""
    B, Fo, Ho, Wo, cin, cout = _out_shape(x, w_packed, kt)
    quantized = x.dtype == torch.int8
    if quantized != (w_packed.dtype == torch.int8) or quantized != (scale is not None):
        raise ValueError("int8 x goes with int8 w and a scale; float x with neither")
    _check_epilogue(quantized, addend, bias, cout, Ho, Wo)
    acc = None
    for tap in range(kt * 9):
        if tap == skip_tap:
            continue
        dt, dh, dw = tap // 9, tap // 3 % 3, tap % 3
        view = x[:, dt:dt + Fo, dh:dh + Ho, dw:dw + Wo].reshape(-1, cin)
        if quantized:
            part = int8_matmul(view, w_packed[tap])
        else:
            part = (view.to(torch.bfloat16).float()
                    @ w_packed[tap].to(torch.bfloat16).float().T)
        acc = part if acc is None else acc.add_(part)
    y = acc.float()
    if quantized:
        y = y * scale.float()
    y = y.reshape(B, Fo, Ho, Wo, cout)
    if addend is not None:
        y += expand_classes(addend, Ho, Wo).permute(1, 2, 0)
    if bias is not None:
        y += bias
    y = y.to(out_dtype)
    return y.permute(0, 4, 1, 2, 3).contiguous() if channels_first else y


def conv_taps_launch(
    x: torch.Tensor, w_packed: torch.Tensor, scale: torch.Tensor | None,
    kt: int = 3, out_dtype: torch.dtype = torch.bfloat16,
    channels_first: bool = False, addend: torch.Tensor | None = None,
    bias: torch.Tensor | None = None,
) -> torch.Tensor:
    """Launch K4 (int8 x, w and an fp32 ``scale [Cout]`` on the device, and
    optionally the fp32 ``addend`` and ``bias`` of :func:`conv_taps_plain`)
    or K5 (bf16 x and w, nothing else) -> ``[B, Fo, Ho, Wo, Cout]``, or the
    contiguous ``[B, Cout, Fo, Ho, Wo]`` with ``channels_first``. Raises on
    what the kernel does not take; nothing here waits for the device."""
    if x.device.type != "cuda":
        raise ValueError(f"K4 and K5 run on cuda, not {x.device}")
    B, Fo, Ho, Wo, cin, cout = _out_shape(x, w_packed, kt)
    quantized = x.dtype == torch.int8
    want = torch.int8 if quantized else torch.bfloat16
    for name, t in (("x", x), ("w", w_packed)):
        if t.dtype != want:
            raise ValueError(f"the CUDA kernel takes int8 or bf16 x and w of one "
                             f"type, got {name} {t.dtype} beside x {x.dtype}")
        if t.device != x.device or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous on {x.device}")
    if x.data_ptr() % 16:
        raise ValueError("x must be 16-byte aligned (TMA)")
    if not kernel_supports(cin, cout):
        raise ValueError(
            f"the CUDA kernel takes Cin % {CIN_MULTIPLE} == 0 and Cout % "
            f"{COUT_MULTIPLE} == 0, got Cin={cin}, Cout={cout}")
    if out_dtype not in OUT_TYPES:
        raise ValueError(f"out_dtype must be bfloat16, float32 or float16, got {out_dtype}")
    if quantized:
        if (scale is None or scale.dtype != torch.float32 or scale.shape != (cout,)
                or scale.device != x.device or not scale.is_contiguous()):
            raise ValueError("K4 takes a contiguous fp32 scale [Cout] on x's device")
    elif scale is not None:
        raise ValueError("K5 takes no scale")
    _check_epilogue(quantized, addend, bias, cout, Ho, Wo)
    for name, t in (("addend", addend), ("bias", bias)):
        if t is not None and (t.device != x.device or not t.is_contiguous()):
            raise ValueError(f"{name} must be contiguous on {x.device}")
    if B > 65535 or x[0].numel() // cin + 2 * TILE_M >= 2**31:
        raise ValueError(f"x {tuple(x.shape)} exceeds the grid's 65535 windows or "
                         "a window's 2^31 flat rows")
    shape = (B, cout, Fo, Ho, Wo) if channels_first else (B, Fo, Ho, Wo, cout)
    out = torch.empty(shape, dtype=out_dtype, device=x.device)
    if channels_first:
        osb, osc, osf, osh, osw = out.stride()
    else:
        osb, osf, osh, osw, osc = out.stride()
    lib = _library()
    image = weight_image(w_packed)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        dims = (B, Fo, Ho, Wo, cin, cout, kt, OUT_TYPES[out_dtype])
        strides = (osb, osf, osh, osw, osc, stream)
        if quantized:
            rc = lib.dove_conv3d_w8a8(
                x.data_ptr(), image.data_ptr(), scale.data_ptr(),
                None if addend is None else addend.data_ptr(),
                None if bias is None else bias.data_ptr(), out.data_ptr(), *dims,
                min(Ho, 3), min(Wo, 3), *strides)
        else:
            rc = lib.dove_conv3d_bf16(x.data_ptr(), image.data_ptr(),
                                      out.data_ptr(), *dims, *strides)
    if rc != 0:
        raise RuntimeError(f"conv3d_taps kernel launch failed: cudaError_t {rc}")
    if shape_log is not None:
        shape_log.append((tuple(x.shape), cout, kt))
    if not quantized:
        launches_bf16.count += 1
    elif kt == 3:
        launches_w8a8.count += 1
    else:
        launches_w8a8_kt1.count += 1
    return out


def conv_taps(
    x: torch.Tensor, w_packed: torch.Tensor, scale: torch.Tensor | None,
    kt: int = 3, out_dtype: torch.dtype = torch.bfloat16,
    channels_first: bool = False, plain: bool = False,
    addend: torch.Tensor | None = None, bias: torch.Tensor | None = None,
) -> torch.Tensor:
    """The tap convolution of a batch of pre-padded windows ``x [B, Fo + kt -
    1, Ho + 2, Wo + 2, Cin]`` against packed weights ``[kt * 9, Cout, Cin]``:
    the kernel on a CUDA tensor, the plain version on a CPU tensor or when
    the caller asks for it."""
    if plain or x.device.type == "cpu":
        return conv_taps_plain(x, w_packed, scale, kt, out_dtype, channels_first,
                               addend=addend, bias=bias)
    return conv_taps_launch(x, w_packed, scale, kt, out_dtype, channels_first,
                            addend, bias)


def _packed_shape(x: torch.Tensor, padding: int) -> tuple[int, ...]:
    if x.ndim != 5 or padding < 0:
        raise ValueError(f"x must be [B, C, F, H, W], got {tuple(x.shape)}")
    B, C, Ft, H, W = x.shape
    return B, Ft, H + 2 * padding, W + 2 * padding, C


def quantize_pack_plain(
    x: torch.Tensor, s: torch.Tensor, m: torch.Tensor,
    eq_inv: torch.Tensor | None = None, padding: int = 1,
) -> torch.Tensor:
    """The codes of NCDHW ``x`` on the grid (s, m) (``ops.quant.asym_codes``)
    -> int8 ``[B, F, H + 2 padding, W + 2 padding, C]`` whose border is the
    code 0: a zeroed buffer and one strided copy into its inside."""
    shape = _packed_shape(x, padding)
    H, W = x.shape[-2:]
    x_q = torch.zeros(shape, dtype=torch.int8, device=x.device)
    inner = x_q[:, :, padding:padding + H, padding:padding + W].permute(0, 4, 1, 2, 3)
    asym_codes(x, s, m, eq_inv, channel_dim=1, out=inner)
    return x_q


def quantize_pack_launch(
    x: torch.Tensor, s: torch.Tensor, m: torch.Tensor,
    eq_inv: torch.Tensor | None = None, padding: int = 1,
) -> torch.Tensor:
    """Launch the quantizer's kernel on a bf16, fp16 or fp32 CUDA ``x``; s, m
    (0-d fp32) and eq_inv stay on the device. A non-contiguous x is copied
    first."""
    if x.device.type != "cuda":
        raise ValueError(f"the quantizer's kernel runs on cuda, not {x.device}")
    shape = _packed_shape(x, padding)
    B, C, Ft, H, W = x.shape
    if x.dtype not in QUANT_INPUT_TYPES or C % 4:
        raise ValueError(f"the quantizer's kernel takes bf16, fp16 or fp32 x with "
                         f"C % 4 == 0, got {x.dtype} with C={C}")
    if shape[2] > 65535 or B * Ft > 65535:
        raise ValueError(f"x {tuple(x.shape)} exceeds the grid's 65535")
    s, m = (t.to(device=x.device, dtype=torch.float32).reshape(1) for t in (s, m))
    mult = off = None
    if eq_inv is not None:
        mult = (eq_inv.float().reshape(-1) / s).contiguous()
        off = -(m / s)
        if mult.shape != (C,):
            raise ValueError(f"eq_inv must hold {C} channels, got {tuple(eq_inv.shape)}")
    x = x.contiguous()
    out = torch.empty(shape, dtype=torch.int8, device=x.device)
    lib = _quant_library()
    with torch.cuda.device(x.device):
        rc = lib.dove_quant_pack(
            x.data_ptr(), None if mult is None else mult.data_ptr(),
            None if off is None else off.data_ptr(), s.data_ptr(), m.data_ptr(),
            out.data_ptr(), B, C, Ft, H, W, padding, QUANT_INPUT_TYPES[x.dtype],
            torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"quant_pack kernel launch failed: cudaError_t {rc}")
    launches_quantize.count += 1
    return out


def quantize_pack(
    x: torch.Tensor, s: torch.Tensor, m: torch.Tensor,
    eq_inv: torch.Tensor | None = None, padding: int = 1, plain: bool = False,
) -> torch.Tensor:
    """The quantizer's last pass: the kernel on a CUDA tensor, the plain
    version on a CPU tensor or when the caller asks for it."""
    if plain or x.device.type == "cpu":
        return quantize_pack_plain(x, s, m, eq_inv, padding)
    return quantize_pack_launch(x, s, m, eq_inv, padding)


def _scale(sx: torch.Tensor, sk: torch.Tensor) -> torch.Tensor:
    return (sx.float() * sk.float()).reshape(-1).contiguous()


def conv3d_w8a8_plain(
    x_q: torch.Tensor, w_q: torch.Tensor, sx: torch.Tensor, sk: torch.Tensor,
    out_dtype: torch.dtype = torch.bfloat16,
) -> torch.Tensor:
    """K4 in plain PyTorch, the JAX signature: int8 ``x_q [F, Hp, Wp, Cin]``
    and ``w_q [3, 3, 3, Cin, Cout]``, fp32 ``sx []`` and ``sk [Cout]`` ->
    ``[Fo, Ho, Wo, Cout]``. Exact in int32, so the kernel is held to it bit
    for bit."""
    return conv_taps_plain(x_q[None], pack_taps(w_q), _scale(sx, sk), 3, out_dtype)[0]


def conv3d_w8a8(
    x_q: torch.Tensor, w_q: torch.Tensor, sx: torch.Tensor, sk: torch.Tensor,
    out_dtype: torch.dtype = torch.bfloat16,
) -> torch.Tensor:
    """VALID 3x3x3 int8 conv of a pre-padded input -> ``[Fo, Ho, Wo, Cout]``
    (K4; the JAX package's ``conv3d_w8a8``)."""
    return conv_taps(x_q[None], pack_taps(w_q), _scale(sx, sk), 3, out_dtype)[0]


def conv3d_bf16_plain(
    x: torch.Tensor, w: torch.Tensor, out_dtype: torch.dtype = torch.bfloat16,
) -> torch.Tensor:
    """K5 in plain PyTorch: the operands rounded to bf16, the 27 products and
    their sum in fp32, one rounding to ``out_dtype``."""
    return conv_taps_plain(x[None], pack_taps(w), None, 3, out_dtype)[0]


def conv3d_bf16(
    x: torch.Tensor, w: torch.Tensor, out_dtype: torch.dtype = torch.bfloat16,
) -> torch.Tensor:
    """VALID 3x3x3 bf16 conv of a pre-padded input -> ``[Fo, Ho, Wo, Cout]``
    (K5; the JAX package's ``conv3d_bf16``): x and w of any float type are
    rounded to bf16 first, as there."""
    if x.device.type == "cpu":
        return conv3d_bf16_plain(x, w, out_dtype)
    return conv_taps_launch(x[None].to(torch.bfloat16).contiguous(),
                            pack_taps(w.to(torch.bfloat16)), None, 3, out_dtype)[0]
