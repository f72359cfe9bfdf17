"""The VAE's norm primitive: silu(GroupNorm(x)), its affine and the decoder's
spatial modulation, one hand-written CUDA kernel pair.

The JAX package's GroupNorm is XLA, not Pallas, so no TPU kernel is ported
here: ``csrc/group_norm_sm90.cu`` is the port's own, and its note says what
bounds it on the H100 (bytes) and how its two passes are laid out. Every norm
of the VAE is followed by SiLU, so the kernel computes

    y = silu((x - mean) * rstd * gamma_c + beta_c)                  (encoder)
    y = silu(((x - mean) * rstd * gamma_c + beta_c) * cy + cb)      (decoder)

per (sample, group) statistics in fp32, the affine folded into a = rstd
gamma_c, b = beta_c - mean a, everything in fp32 and one rounding to x's type
(bf16, fp16 or fp32). ``cy`` and ``cb`` are SpatialNorm3d's 1x1x1 convs of the
latent at latent resolution ``[B, C, Fl, Hl, Wl]``; the kernel reads them by
nearest index, with the causal first-frame rule of the VAE's
``_nearest_resize_causal`` where ``first``: frame 0 maps to latent frame 0
alone when x's frame count is odd and above 1, the rest uniformly onto
latent frames 1 and on. The full-size resized tensors are never made.

The kernel has two forms, chosen by x's layout. An NCDHW x takes the first
(two passes); a channels-last x (``torch.channels_last_3d``: NDHWC memory,
the layout of the VAE's activations on the card) takes the second (three
passes: statistics, their fold into each channel's a and b, apply), which
writes a channels-last output and can put the next causal conv's ``lead``
left frames in front of it: ``left`` (the conv's cache from the previous
chunk) or, at a clip's start, frame 0 of the output repeated, as the conv
pads. The conv then reads its input in place, with no concatenation.

:func:`group_norm_silu` launches the kernel for a CUDA tensor and runs the
same arithmetic in float32 PyTorch for a CPU tensor:
:func:`group_norm_silu_plain` (NCDHW) or :func:`group_norm_silu_cl_plain`
(the channels-last form, statistics taken over NDHWC rows); the plain
versions are what the tests hold the kernel to. The VAE's own CPU route is
not this plain version but its model-dtype chain (``models/vae.py``), which
the JAX package's parity tests pin. Launches (one each call) are counted in
``launches``.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from dove_tpu_torch import kernels
from dove_tpu_torch.obs import LaunchCounter

launches = LaunchCounter()

INPUT_TYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
THREADS = 256  # the kernels' block
# A span is cut into enough chunks for WAVES rounds of BLOCKS_PER_SM blocks on
# every SM, never fewer than one vector a thread, at most MAX_SPLITS.
WAVES, BLOCKS_PER_SM, MAX_SPLITS = 4, 8, 1024


def splits(spans: int, span_len: int, itemsize: int, sms: int) -> int:
    """Chunks a (sample, group) span is cut into, from the shape alone."""
    vectors = span_len * itemsize // 16
    want = -(-WAVES * BLOCKS_PER_SM * sms // spans)
    return max(1, min(want, vectors // THREADS, MAX_SPLITS))


def modulation_ratios(frames: int, height: int, width: int, latent: tuple[int, int, int],
                      first: bool) -> tuple[int, int, int, bool]:
    """(rf, rh, rw, causal): how many of x's frames, rows and columns fall on
    one of the latent's. Raises where the nearest resize of the VAE would."""
    lf, lh, lw = latent
    causal = first and frames > 1 and frames % 2 == 1
    if causal:
        if lf < 2 or (frames - 1) % (lf - 1):
            raise ValueError(f"non-integer causal resize of {lf} frames to {frames}")
        rf = (frames - 1) // (lf - 1)
    else:
        if frames % lf:
            raise ValueError(f"non-integer resize of {lf} frames to {frames}")
        rf = frames // lf
    if height % lh or width % lw:
        raise ValueError(f"non-integer resize {(lh, lw)} -> {(height, width)}")
    return rf, height // lh, width // lw, causal


def modulation_index(frames: int, height: int, width: int, latent: tuple[int, int, int],
                     first: bool, device=None) -> tuple[torch.Tensor, ...]:
    """The latent frame, row and column each of x's frames, rows and columns
    reads: the kernel's rule as index vectors."""
    rf, rh, rw, causal = modulation_ratios(frames, height, width, latent, first)
    f = torch.arange(frames, device=device)
    fi = torch.where(f == 0, 0, 1 + (f - 1).clamp(min=0) // rf) if causal else f // rf
    return (fi, torch.arange(height, device=device) // rh,
            torch.arange(width, device=device) // rw)


def channels_last(x: torch.Tensor) -> bool:
    """Whether x [B, C, F, H, W] lies in memory NDHWC and not NCDHW."""
    return (x.ndim == 5 and x.is_contiguous(memory_format=torch.channels_last_3d)
            and not x.is_contiguous())


def with_left_frames(y: torch.Tensor, lead: int, left: torch.Tensor | None) -> torch.Tensor:
    """[B, C, F, H, W] -> [B, C, lead + F, H, W] channels-last: ``left``
    ([B, C, lead, H, W]) or, where it is None, y's frame 0 repeated, in front
    of y. What the kernel's channels-last form writes; one copy of y."""
    B, C, Fr, H, W = y.shape
    out = torch.empty((B, C, lead + Fr, H, W), dtype=y.dtype, device=y.device,
                      memory_format=torch.channels_last_3d)
    out[:, :, lead:] = y
    if lead:
        out[:, :, :lead] = y[:, :, :1] if left is None else left
    return out


def _check(x: torch.Tensor, groups: int, cy, cb) -> None:
    if x.ndim != 5:
        raise ValueError(f"x must be [B, C, F, H, W], got {tuple(x.shape)}")
    if groups <= 0 or x.shape[1] % groups:
        raise ValueError(f"{x.shape[1]} channels do not split into {groups} groups")
    if (cy is None) != (cb is None):
        raise ValueError("the modulation takes both cy and cb, or neither")
    if cy is not None and (cy.shape != cb.shape or cy.ndim != 5
                           or cy.shape[:2] != x.shape[:2]):
        raise ValueError(f"cy, cb must be [B, C, Fl, Hl, Wl] beside x "
                         f"{tuple(x.shape)}, got {tuple(cy.shape)}, {tuple(cb.shape)}")


def group_norm_silu_plain(
    x: torch.Tensor, groups: int, weight: torch.Tensor, bias: torch.Tensor, eps: float,
    cy: torch.Tensor | None = None, cb: torch.Tensor | None = None, first: bool = True,
) -> torch.Tensor:
    """The kernel's function in float32 PyTorch: gamma, beta, cy and cb taken
    in x's type as the kernel reads them, one rounding at the end."""
    _check(x, groups, cy, cb)
    B, C, Fr, H, W = x.shape
    xf = x.float().reshape(B, groups, -1)
    var, mean = torch.var_mean(xf, dim=-1, unbiased=False, keepdim=True)
    rstd = torch.rsqrt(var + eps)
    a = rstd * weight.to(x.dtype).float().view(1, groups, -1)  # [B, G, C / G]
    b = bias.to(x.dtype).float().view(1, groups, -1) - mean * a
    y = (xf.view(B, groups, C // groups, -1) * a[..., None] + b[..., None]).view(x.shape)
    if cy is not None:
        fi, hi, wi = modulation_index(Fr, H, W, tuple(cy.shape[2:]), first, x.device)

        def full(t: torch.Tensor) -> torch.Tensor:
            return t.to(x.dtype).float()[:, :, fi][:, :, :, hi][:, :, :, :, wi]

        y = y * full(cy) + full(cb)
    return torch.nn.functional.silu(y).to(x.dtype)


def _check_left(x: torch.Tensor, lead: int, left: torch.Tensor | None) -> None:
    if lead < 0:
        raise ValueError(f"lead must be 0 or more, got {lead}")
    if left is not None and tuple(left.shape) != (x.shape[0], x.shape[1], lead) + tuple(
            x.shape[3:]):
        raise ValueError(f"left must be [B, C, {lead}, H, W] beside x {tuple(x.shape)}, "
                         f"got {tuple(left.shape)}")


def group_norm_silu_cl_plain(
    x: torch.Tensor, groups: int, weight: torch.Tensor, bias: torch.Tensor, eps: float,
    cy: torch.Tensor | None = None, cb: torch.Tensor | None = None, first: bool = True,
    lead: int = 0, left: torch.Tensor | None = None,
) -> torch.Tensor:
    """The channels-last form's function in float32 PyTorch, over NDHWC rows
    as the kernel reads them: each group's statistics over its channels of
    every position, each channel's a and b, the modulation gathered from
    channels-last cy and cb by nearest index, one rounding; the output
    channels-last with its ``lead`` left frames (``left``, or frame 0
    repeated) in front."""
    _check(x, groups, cy, cb)
    _check_left(x, lead, left)
    B, C, Fr, H, W = x.shape
    rows = x.permute(0, 2, 3, 4, 1).float().reshape(B, -1, groups, C // groups)
    var, mean = torch.var_mean(rows, dim=(1, 3), unbiased=False, keepdim=True)
    a = torch.rsqrt(var + eps) * weight.to(x.dtype).float().view(1, 1, groups, -1)
    b = bias.to(x.dtype).float().view(1, 1, groups, -1) - mean * a
    y = (rows * a + b).view(B, Fr, H, W, C)
    if cy is not None:
        fi, hi, wi = modulation_index(Fr, H, W, tuple(cy.shape[2:]), first, x.device)

        def full(t: torch.Tensor) -> torch.Tensor:
            t = t.to(x.dtype).float().permute(0, 2, 3, 4, 1)  # [B, Fl, Hl, Wl, C]
            return t[:, fi][:, :, hi][:, :, :, wi]

        y = y * full(cy) + full(cb)
    y = torch.nn.functional.silu(y).to(x.dtype).permute(0, 4, 1, 2, 3)
    return with_left_frames(y, lead, None if left is None else left.to(x.dtype))


@functools.lru_cache(maxsize=None)
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _library() -> ctypes.CDLL:
    lib = kernels.load("group_norm_sm90")
    fn = lib.dove_group_norm_silu
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 7 + [ctypes.c_float]
                       + [ctypes.c_int] * 5 + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        cl = lib.dove_group_norm_silu_cl
        cl.argtypes = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 7 + [ctypes.c_float]
                       + [ctypes.c_int] * 6 + [ctypes.c_void_p])
        cl.restype = ctypes.c_int
    return lib


def takes_channels_last(channels: int, groups: int, itemsize: int) -> bool:
    """Whether the channels-last form takes these widths: a row of whole
    16-byte vectors, a power of two of them up to one a thread, and a group
    a whole number of vectors or a whole part of one."""
    vec = 16 // itemsize
    cols, cg = channels // vec, channels // groups
    return (channels % vec == 0 and 0 < cols <= THREADS and cols & (cols - 1) == 0
            and (cg % vec == 0 or vec % cg == 0))


def _aligned(t: torch.Tensor, memory_format=torch.contiguous_format) -> torch.Tensor:
    t = t.contiguous(memory_format=memory_format)
    return t.clone(memory_format=memory_format) if t.data_ptr() % 16 else t


def group_norm_silu_launch(
    x: torch.Tensor, groups: int, weight: torch.Tensor, bias: torch.Tensor, eps: float,
    cy: torch.Tensor | None = None, cb: torch.Tensor | None = None, first: bool = True,
    lead: int = 0, left: torch.Tensor | None = None,
) -> torch.Tensor:
    """Launch the kernel on a bf16, fp16 or fp32 CUDA ``x``, in x's type.
    weight, bias, cy, cb and left are taken in x's type. An NCDHW x without
    ``lead`` or ``left`` takes the NCDHW form and gets an NCDHW output (a
    non-contiguous or unaligned x is copied first); a channels-last x, or a
    call with ``lead`` or ``left``, takes the channels-last form and gets
    ``[B, C, lead + F, H, W]`` channels-last (x copied to channels-last
    where it is not; widths the form does not take go through the NCDHW
    form and :func:`with_left_frames`)."""
    if x.device.type != "cuda":
        raise ValueError(f"the GroupNorm kernel runs on cuda, not {x.device}")
    if x.dtype not in INPUT_TYPES:
        raise ValueError(f"the GroupNorm kernel takes bf16, fp16 or fp32 x, got {x.dtype}")
    _check(x, groups, cy, cb)
    _check_left(x, lead, left)
    B, C, Fr, H, W = x.shape
    latent, causal = (1, 1, 1), False
    if cy is not None:
        latent = tuple(cy.shape[2:])
        causal = modulation_ratios(Fr, H, W, latent, first)[3]  # raises where no integer ratio
    cl = lead > 0 or left is not None or channels_last(x)
    if cl and not takes_channels_last(C, groups, x.element_size()):
        y = group_norm_silu_launch(x.contiguous(), groups, weight, bias, eps, cy, cb, first)
        return with_left_frames(y, lead, None if left is None else left.to(x.dtype))
    fmt = torch.channels_last_3d if cl else torch.contiguous_format
    if cy is not None:
        cy, cb = (_aligned(t.to(x.dtype), fmt) for t in (cy, cb))
    x = _aligned(x, fmt)
    weight, bias = (t.to(x.dtype).contiguous() for t in (weight, bias))
    index = x.device.index if x.device.index is not None else torch.cuda.current_device()
    sms = _sms(index)
    lib = _library()
    if cl:
        if (Fr + lead) * H * W >= 2**31:
            raise ValueError(f"a sample of x {tuple(x.shape)} exceeds 2^31 positions")
        n_split = splits(B, Fr * H * W * C, x.element_size(), sms)
        partials = torch.empty(B * n_split * groups * 3, dtype=torch.float32, device=x.device)
        ab = torch.empty(B * C * 2, dtype=torch.float32, device=x.device)
        out = torch.empty((B, C, lead + Fr, H, W), dtype=x.dtype, device=x.device,
                          memory_format=torch.channels_last_3d)
        if left is not None:
            left = _aligned(left.to(x.dtype), torch.channels_last_3d)
        with torch.cuda.device(x.device):
            rc = lib.dove_group_norm_silu_cl(
                x.data_ptr(), weight.data_ptr(), bias.data_ptr(),
                None if cy is None else cy.data_ptr(), None if cb is None else cb.data_ptr(),
                None if left is None else left.data_ptr(), out.data_ptr(),
                partials.data_ptr(), ab.data_ptr(), B, C, Fr, H, W, groups, n_split,
                float(eps), *latent, int(causal), lead, INPUT_TYPES[x.dtype],
                torch.cuda.current_stream(x.device).cuda_stream)
    else:
        span_len = C // groups * Fr * H * W
        if span_len >= 2**31:
            raise ValueError(f"a group of x {tuple(x.shape)} exceeds 2^31 elements")
        n_split = splits(B * groups, span_len, x.element_size(), sms)
        partials = torch.empty(B * groups * n_split * 3, dtype=torch.float32, device=x.device)
        out = torch.empty_like(x)
        with torch.cuda.device(x.device):
            rc = lib.dove_group_norm_silu(
                x.data_ptr(), weight.data_ptr(), bias.data_ptr(),
                None if cy is None else cy.data_ptr(), None if cb is None else cb.data_ptr(),
                out.data_ptr(), partials.data_ptr(), B, C, Fr, H, W, groups, n_split,
                float(eps), *latent, int(causal), INPUT_TYPES[x.dtype],
                torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"group_norm kernel launch failed: cudaError_t {rc}")
    launches.add(x.shape)
    return out


def group_norm_silu(
    x: torch.Tensor, groups: int, weight: torch.Tensor, bias: torch.Tensor, eps: float,
    cy: torch.Tensor | None = None, cb: torch.Tensor | None = None, first: bool = True,
    lead: int = 0, left: torch.Tensor | None = None,
) -> torch.Tensor:
    """silu(GroupNorm(x)), modulated where cy and cb are given: the kernel on
    a CUDA tensor, the plain version of the form it would take on a CPU
    tensor."""
    if x.device.type == "cpu":
        if lead > 0 or left is not None or channels_last(x):
            return group_norm_silu_cl_plain(x, groups, weight, bias, eps, cy, cb, first,
                                            lead, left)
        return group_norm_silu_plain(x, groups, weight, bias, eps, cy, cb, first)
    return group_norm_silu_launch(x, groups, weight, bias, eps, cy, cb, first, lead, left)
