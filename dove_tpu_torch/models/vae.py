"""CogVideoX 3D causal VAE in PyTorch: bf16/fp32, or with int8 convs.

Counterpart of ``dove_tpu/models/vae.py``:

  * 8x spatial / 4x temporal compression, 16 latent channels;
  * causal 3D convs: at a clip's start the first frame is replicated as
    temporal left padding; chunked processing threads a cache of every
    causal conv's trailing k_t-1 input frames, so chunked and whole-clip
    results agree;
  * encoder temporal mean-pool and decoder temporal upsampling treat an odd
    leading frame as the clip's causal first frame;
  * a conv that ``ops.quant.quantize_vae`` swapped for a ``QConv3d`` runs as
    an int8 convolution (``ops.quant.qconv``: K4 on the card);
  * :func:`set_pallas_conv` routes the eligible float 3x3x3 convs through K5,
    the hand-written bf16 conv, instead of cuDNN (off by default);
  * the decode runs with gradients through its activations (stage 2's pixel
    loss; the parameters stay frozen), optionally checkpointed a decoder
    level at a time (``remat``). K4 and K5 have no backward, so an int8 conv
    or K5 on an input that needs a gradient raises;
  * :func:`calibrate` and :func:`attribute_quant_error` run a forward with
    taps on every named conv: per-input-channel activation amax and tap
    autocorrelation for ``quantize_vae``, or each quantizable conv's own int8
    error;
  * the feathered spatial tilers of diffusers' ``enable_tiling`` semantics,
    assembled on the device (``tiled_encode_moments``, ``tiled_decode``);
    the JAX package's host-assembled ``*_host`` twins are not ported.

The parameters live in ``nn.Module``s named like the diffusers checkpoint
(``encoder.down_blocks.0.resnets.1.conv1.conv.weight``, ...), so a released
state dict loads with ``load_state_dict``. The forward code is functional
over those modules. Public functions keep the JAX package's [B, F, H, W, C]
layout; inside, activations are [B, C, F, H, W] tensors, laid out by route.

The card's route (:func:`_on_card`: a CUDA tensor in bf16, fp16 or fp32
whose computation needs no gradient: serving, the training encode under
``no_grad``) keeps every activation channels-last (NDHWC memory,
``torch.channels_last_3d`` strides) from the VAE's entry to its exit, the
layout cuDNN's convolutions read without transposing. Every GroupNorm of the
VAE is followed by SiLU and then by a causal 3x3x3 conv; there the norm is
the hand-written kernel of ``ops.group_norm``: fp32 statistics split across
the card, then one pass that applies the norm, its affine, the decoder's
spatial modulation (read from the latent-resolution convs by nearest index,
never resized) and SiLU, all in fp32 and rounded once to the model dtype,
written channels-last with the conv's two left frames already in front (its
cache, or frame 0 repeated at a clip's start), so the conv reads its input
in place and nothing is concatenated. The float convs run on cuDNN with
channels-last input and weight (each weight is converted in place on its
first such call); the upsamplers write their nearest resize once; the int8
convs (K4) and K5 take their input as they always did and hand back
channels-last.

Elsewhere (CPU tensors, and inputs that need a gradient: stage 2's decode
and its ``remat`` recompute) the VAE runs the plain chain the JAX package
computes, NCDHW: statistics in fp32, the affine, the modulation and SiLU each
in the model dtype, ``torch.cat`` for the causal frames. The kernel's one
rounding is at least as precise as the plain chain's four.

Counted in the open ``obs`` unit: ``vae.norm_n`` at every norm site and
``vae.norm_fused_n`` where it took the kernel; ``vae.conv_n`` for every float
conv run on the card, ``vae.conv_cl_n`` where its input was channels-last,
and ``vae.causal_inplace_n`` for the causal convs that read their left frames
in place.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from dove_tpu_torch import obs
from dove_tpu_torch.config import VAEConfig
from dove_tpu_torch.ops import conv3d_int8, group_norm, quant

Cache = dict[str, torch.Tensor]

# Serving-only switch for K5, the hand-written bf16 3x3x3 conv
# (ops/conv3d_int8.py). Off by default, as in the JAX package: the kernel has
# no backward, and cuDNN's convolution stays the default route.
_HAND_BF16_CONV = False


def set_pallas_conv(enabled: bool) -> None:
    """Route every eligible float conv (3x3x3, both channel counts multiples
    of 128) through K5 from now on. The name is the JAX package's, whose
    switch selects its Pallas kernel; here it selects the CUDA one. Process
    wide: a trainer built after a serving pipeline turns it off first."""
    global _HAND_BF16_CONV
    _HAND_BF16_CONV = enabled


# --- activation calibration (int8 channel equalization) --------------------
# While _CALIB is a dict, every named conv records the per-input-channel amax
# of its input into it, and once the input's tap autocorrelation. Keys are
# "<scope>.<conv name>": the scope is set by encoder_/decoder_forward, the
# names are the conv-cache keys ("up.0.res.1.conv1", ...), and
# ops.quant.module_calib_name derives the same names from module paths.
_CALIB: dict[str, torch.Tensor] | None = None
_CALIB_SCOPE = ""


def _calib_tap(name: str | None, x: torch.Tensor, lead: int = 0) -> None:
    """Record the conv input x, less its ``lead`` causal frames in front."""
    if _CALIB is None or name is None:
        return
    key = f"{_CALIB_SCOPE}.{name}"
    xf = x[:, :, lead:].float()
    amax = xf.abs().amax(dim=(0, 2, 3, 4))
    _CALIB[key] = torch.maximum(_CALIB[key], amax) if key in _CALIB else amax
    tkey = f"{key}#tapcorr"
    if tkey not in _CALIB:  # the first capture wins; the amax folds over calls
        _CALIB[tkey] = _tap_autocorr(xf)


def _tap_autocorr(xf: torch.Tensor, reach: int = 2) -> torch.Tensor:
    """NCDHW [B, C, F, H, W] -> [2r+1, 2r+1, 2r+1] normalized autocorrelation
    c(d) = E[x(p) x(p+d)] / E[x^2] over (frame, h, w) shifts: the statistics
    behind ``gptq_tap_rounding``. Entries with no valid overlap are 0."""
    _, _, Fr, H, W = xf.shape
    denom = xf.square().mean() + 1e-12
    n = 2 * reach + 1
    rows = []
    for dt in range(-reach, reach + 1):
        for dh in range(-reach, reach + 1):
            for dw in range(-reach, reach + 1):
                if Fr <= abs(dt) or H <= abs(dh) or W <= abs(dw):
                    rows.append(torch.zeros((), dtype=torch.float32, device=xf.device))
                    continue
                a = xf[:, :, max(dt, 0):Fr + min(dt, 0),
                       max(dh, 0):H + min(dh, 0), max(dw, 0):W + min(dw, 0)]
                b = xf[:, :, max(-dt, 0):Fr + min(-dt, 0),
                       max(-dh, 0):H + min(-dh, 0), max(-dw, 0):W + min(-dw, 0)]
                rows.append((a * b).mean() / denom)
    return torch.stack(rows).reshape(n, n, n)


@torch.no_grad()
def calibrate(fn, *args):
    """Run ``fn(*args)`` once with the calibration taps on -> (fn's output,
    {name: per-channel amax, name + "#tapcorr": autocorrelation})."""
    global _CALIB
    _CALIB = {}
    try:
        out = fn(*args)
        return out, dict(_CALIB)
    finally:
        _CALIB = None


# --- per-layer quantization-error attribution -------------------------------
# While _QERR is a dict, every quantizable float conv also runs its int8
# version on the same input and records the squared error and norm of its
# output. The float activations keep flowing, so each record is the layer's
# own rounding error. _QERR_CALIB carries calibrate()'s stats, so that the
# measured quantizer is the equalized one when serving would equalize.
_QERR: dict[str, tuple[torch.Tensor, torch.Tensor]] | None = None
_QERR_CALIB: dict | None = None


def _qerr_active(name: str | None, conv: nn.Module) -> bool:
    if _QERR is None or name is None or isinstance(conv, quant.QConv3d):
        return False
    return quant.should_quantize_conv(conv.weight)


def _qerr_leaf(conv: nn.Module, name: str) -> quant.QConv3d:
    # as in the JAX package, the tap autocorrelation is not passed on: the
    # attribution measures round-to-nearest weights
    amax = (_QERR_CALIB or {}).get(f"{_CALIB_SCOPE}.{name}")
    return quant.quantize_conv(
        conv, with_ksum=True,
        calib_amax=None if amax is None else torch.as_tensor(amax))


def _qerr_record(name: str, y: torch.Tensor, y_q: torch.Tensor) -> None:
    key = f"{_CALIB_SCOPE}.{name}"
    e2 = (y_q.float() - y.float()).square().sum()
    n2 = y.float().square().sum()
    if key in _QERR:
        pe, pn = _QERR[key]
        e2, n2 = pe + e2, pn + n2
    _QERR[key] = (e2, n2)


@torch.no_grad()
def attribute_quant_error(fn, *args, calib: dict | None = None):
    """Run ``fn(*args)`` once with the quantization-error taps on -> (fn's
    output, {name: (sum of squared error, sum of squared output)}); a layer's
    relative error is sqrt(err / norm). ``calib`` equalizes the measured
    quantizer. Convs that are already int8 are skipped."""
    global _QERR, _QERR_CALIB
    _QERR, _QERR_CALIB = {}, calib
    try:
        out = fn(*args)
        return out, dict(_QERR)
    finally:
        _QERR, _QERR_CALIB = None, None


def _set_scope(scope: str) -> None:
    global _CALIB_SCOPE
    if _CALIB is not None or _QERR is not None:
        _CALIB_SCOPE = scope


# ---------------------------------------------------------------------------
# Parameter modules (diffusers naming)
# ---------------------------------------------------------------------------

class CausalConv3d(nn.Module):
    def __init__(self, cin: int, cout: int, k: int, **kw):
        super().__init__()
        self.conv = nn.Conv3d(cin, cout, k, **kw)


class Conv2dHolder(nn.Module):
    """Per-frame 2D conv of a down/upsampler (diffusers' ``.conv``)."""

    def __init__(self, ch: int, **kw):
        super().__init__()
        self.conv = nn.Conv2d(ch, ch, 3, **kw)


class SpatialNorm3d(nn.Module):
    def __init__(self, ch: int, zq_ch: int, groups: int, eps: float, **kw):
        super().__init__()
        self.norm_layer = nn.GroupNorm(groups, ch, eps, **kw)
        self.conv_y = CausalConv3d(zq_ch, ch, 1, **kw)
        self.conv_b = CausalConv3d(zq_ch, ch, 1, **kw)


class ResnetBlock3d(nn.Module):
    def __init__(self, cfg: VAEConfig, cin: int, cout: int, zq_ch: int | None, **kw):
        super().__init__()

        def norm(ch: int) -> nn.Module:
            if zq_ch is None:
                return nn.GroupNorm(cfg.norm_num_groups, ch, cfg.norm_eps, **kw)
            return SpatialNorm3d(ch, zq_ch, cfg.norm_num_groups, cfg.norm_eps, **kw)

        self.norm1 = norm(cin)
        self.conv1 = CausalConv3d(cin, cout, 3, **kw)
        self.norm2 = norm(cout)
        self.conv2 = CausalConv3d(cout, cout, 3, **kw)
        self.conv_shortcut = nn.Conv3d(cin, cout, 1, **kw) if cin != cout else None


class _Level(nn.Module):
    def __init__(self, cfg, cin, cout, n_res, zq_ch, sampler: str | None, **kw):
        super().__init__()
        self.resnets = nn.ModuleList(
            [ResnetBlock3d(cfg, cin if j == 0 else cout, cout, zq_ch, **kw)
             for j in range(n_res)]
        )
        if sampler is not None:
            setattr(self, sampler, nn.ModuleList([Conv2dHolder(cout, **kw)]))


class Encoder(nn.Module):
    def __init__(self, cfg: VAEConfig, **kw):
        super().__init__()
        chans = cfg.block_out_channels
        n = len(chans)
        self.conv_in = CausalConv3d(cfg.in_channels, chans[0], 3, **kw)
        self.down_blocks = nn.ModuleList([
            _Level(cfg, chans[max(i - 1, 0)], chans[i], cfg.layers_per_block,
                   None, "downsamplers" if i < n - 1 else None, **kw)
            for i in range(n)
        ])
        self.mid_block = _Level(cfg, chans[-1], chans[-1], 2, None, None, **kw)
        self.norm_out = nn.GroupNorm(cfg.norm_num_groups, chans[-1], cfg.norm_eps, **kw)
        self.conv_out = CausalConv3d(chans[-1], 2 * cfg.latent_channels, 3, **kw)


class Decoder(nn.Module):
    def __init__(self, cfg: VAEConfig, **kw):
        super().__init__()
        rev = list(reversed(cfg.block_out_channels))
        n = len(rev)
        zq = cfg.latent_channels
        self.conv_in = CausalConv3d(cfg.latent_channels, rev[0], 3, **kw)
        self.mid_block = _Level(cfg, rev[0], rev[0], 2, zq, None, **kw)
        self.up_blocks = nn.ModuleList([
            _Level(cfg, rev[max(i - 1, 0)], rev[i], cfg.layers_per_block + 1,
                   zq, "upsamplers" if i < n - 1 else None, **kw)
            for i in range(n)
        ])
        self.norm_out = SpatialNorm3d(
            rev[-1], zq, cfg.norm_num_groups, cfg.norm_eps, **kw
        )
        self.conv_out = CausalConv3d(rev[-1], cfg.out_channels, 3, **kw)


class AutoencoderKLCogVideoX(nn.Module):
    """Parameter container of the VAE; see encode_moments / decode."""

    def __init__(self, cfg: VAEConfig, device=None, dtype=None):
        super().__init__()
        kw = {"device": device, "dtype": dtype}
        self.cfg = cfg
        self.encoder = Encoder(cfg, **kw)
        self.decoder = Decoder(cfg, **kw)


# ---------------------------------------------------------------------------
# Primitives (activations [B, C, F, H, W]: channels-last on the card's route)
# ---------------------------------------------------------------------------

CHANNELS_LAST = torch.channels_last_3d


def _on_card(x: torch.Tensor, *modules: nn.Module, zq: torch.Tensor | None = None) -> bool:
    """The card's route (module docstring): x a CUDA tensor in a type the
    kernels take, and nothing of the step (x, ``zq``, the modules'
    parameters) needing a gradient."""
    if x.device.type != "cuda" or x.dtype not in group_norm.INPUT_TYPES:
        return False
    if not torch.is_grad_enabled():
        return True
    return not (x.requires_grad or (zq is not None and zq.requires_grad)
                or any(t.requires_grad for m in modules for t in m.parameters()))


def _cl_weight(conv: nn.Module) -> torch.Tensor:
    """A float conv's weight channels-last, as cuDNN reads it beside a
    channels-last input: the parameter is converted in place on the first
    call (the same values), so no later call copies it. The copy is made
    outside inference mode, so the parameter stays usable under autograd."""
    w = conv.weight
    fmt = CHANNELS_LAST if w.ndim == 5 else torch.channels_last
    if not w.is_contiguous(memory_format=fmt):
        with torch.inference_mode(False):
            w.data = w.data.contiguous(memory_format=fmt)
    return w


def _count_conv(x: torch.Tensor, card: bool, in_place: bool = False) -> None:
    if x.device.type == "cuda":
        obs.count("vae.conv_n", 1)
        if card:
            obs.count("vae.conv_cl_n", 1)
        if in_place:
            obs.count("vae.causal_inplace_n", 1)


def _float_conv3d(conv: nn.Module, x: torch.Tensor, card: bool, **kw) -> torch.Tensor:
    """cuDNN's conv: channels-last input and weight on the card's route, and
    so a channels-last output; NCDHW ones elsewhere, as always. A 2D conv's
    weight runs as a k_t = 1 3D conv's."""
    if card:
        x, w = x.contiguous(memory_format=CHANNELS_LAST), _cl_weight(conv)
    else:
        w = conv.weight.contiguous()
    return F.conv3d(x, w.unsqueeze(2) if w.ndim == 4 else w, conv.bias, **kw)


def causal_conv3d(
    p: CausalConv3d | nn.Module, x: torch.Tensor, cache: torch.Tensor | None,
    keep_cache: bool = True, name: str | None = None, framed: bool = False,
) -> tuple[torch.Tensor, torch.Tensor | None]:
    """Causal 3D conv: temporal left context from ``cache`` (or first-frame
    replicate at clip start), symmetric zero spatial padding. ``framed``: x
    already carries its k_t-1 left frames in front of its own (the fused
    norm wrote them there), so nothing is concatenated and ``cache`` is not
    read.

    A ``QConv3d`` runs as an int8 convolution; an eligible float conv runs
    through K5 when :func:`set_pallas_conv` is on; the rest through cuDNN,
    channels-last on the card's route. ``name`` (the conv-cache key) feeds
    the calibration and attribution taps. Returns (output, new_cache): the
    trailing k_t-1 input frames for the next chunk (a copy, so it does not
    keep the padded input alive), or None when k_t == 1 or the caller does
    not keep caches."""
    conv = p.conv if isinstance(p, CausalConv3d) else p
    quantized = isinstance(conv, quant.QConv3d)
    kt, kh, kw = (conv.kt, 3, 3) if quantized else conv.weight.shape[2:]
    _calib_tap(name, x, kt - 1 if framed else 0)
    if _qerr_active(name, conv):  # attribution: also run the int8 version
        y_q, _ = causal_conv3d(_qerr_leaf(conv, name), x, cache, False, framed=framed)
        y, new_cache = causal_conv3d(conv, x, cache, keep_cache, framed=framed)  # no re-tap
        _qerr_record(name, y, y_q)
        return y, new_cache
    hand = (not quantized and _HAND_BF16_CONV and (kt, kh, kw) == (3, 3, 3)
            and conv.in_channels % 128 == 0 and conv.out_channels % 128 == 0)
    if quantized or hand:
        _refuse_grad(x, "K4, the int8 conv" if quantized else "K5 (hand_conv)")
    card = _on_card(x, conv)
    new_cache = None
    if kt > 1:
        if not framed:
            if card:  # conv_in, a conv the norm does not feed: one copy
                x = group_norm.with_left_frames(x, kt - 1, cache)
            else:
                if cache is None:
                    left = x[:, :, :1].expand(-1, -1, kt - 1, -1, -1)
                else:
                    left = cache.to(x.dtype)
                x = torch.cat([left, x], dim=2)
        if keep_cache:
            new_cache = x[:, :, -(kt - 1):].clone()
    if quantized:  # K4 takes NCDHW; on the card its output goes back channels-last
        y = quant.qconv(conv, x.contiguous(), stride=1, padding=1)
        return (y.contiguous(memory_format=CHANNELS_LAST) if card else y), new_cache
    _count_conv(x, card, in_place=card and framed and kt > 1)
    if hand:
        return _hand_conv3d(conv, x, card), new_cache
    y = _float_conv3d(conv, x, card, padding=(0, (kh - 1) // 2, (kw - 1) // 2))
    return y, new_cache


def _refuse_grad(x: torch.Tensor, route: str) -> None:
    """K4 and K5 have no backward (nor have the JAX package's Pallas convs):
    a conv on their route whose input needs a gradient raises, rather than
    run on another route than the one asked for."""
    if x.requires_grad:
        raise RuntimeError(
            f"{route} has no backward: a VAE pass with gradients (stage 2's "
            "decode) needs the float VAE with hand_conv off")


def _hand_conv3d(conv: nn.Conv3d, x: torch.Tensor, channels_last: bool = False) -> torch.Tensor:
    """K5's route: x with its causal frames (either layout) -> bf16
    channels-last with the spatial border in place (the kernel computes
    VALID), weights rounded to bf16 in the kernel's tap layout, the output
    in x's dtype, NCDHW or, with ``channels_last``, channels-last."""
    B, C, Ft, H, W = x.shape
    xp = torch.zeros((B, Ft, H + 2, W + 2, C), dtype=torch.bfloat16, device=x.device)
    xp[:, :, 1:-1, 1:-1].permute(0, 4, 1, 2, 3).copy_(x)
    wp = conv3d_int8.pack_taps(conv.weight.permute(2, 3, 4, 1, 0).to(torch.bfloat16))
    y = conv3d_int8.conv_taps(xp, wp, None, 3, x.dtype, channels_first=not channels_last)
    if channels_last:
        y = y.permute(0, 4, 1, 2, 3)
    if conv.bias is not None:
        y = y + conv.bias.to(y.dtype).view(1, -1, 1, 1, 1)
    return y


def _conv_per_frame(
    p: Conv2dHolder, x: torch.Tensor, stride: int, padding: int,
    name: str | None = None,
) -> torch.Tensor:
    """The down/upsampler's 2D conv on every frame, as a k_t=1 3D conv."""
    _calib_tap(name, x)
    if _qerr_active(name, p.conv):  # attribution: also run the int8 version
        y_q = quant.qconv(_qerr_leaf(p.conv, name), x, stride, padding)
        y = _conv_per_frame(p, x, stride, padding)  # name omitted: no re-tap
        _qerr_record(name, y, y_q)
        return y
    card = _on_card(x, p.conv)
    if isinstance(p.conv, quant.QConv3d):
        _refuse_grad(x, "K4, the int8 conv")
        if not card:
            return quant.qconv(p.conv, x, stride, padding)
        y = quant.qconv(p.conv, x.contiguous(), stride, padding)
        return y.contiguous(memory_format=CHANNELS_LAST)
    _count_conv(x, card)
    return _float_conv3d(p.conv, x, card, stride=(1, stride, stride),
                         padding=(0, padding, padding))


def _group_norm(p: nn.GroupNorm, x: torch.Tensor) -> torch.Tensor:
    """GroupNorm with fp32 statistics (torch's group_norm accumulates bf16
    input in fp32 and rounds once); the affine runs in the model dtype."""
    y = F.group_norm(x, p.num_groups, eps=p.eps)
    shape = (1, -1) + (1,) * (x.ndim - 2)
    return y * p.weight.to(x.dtype).view(shape) + p.bias.to(x.dtype).view(shape)


def _expand_into(dst: torch.Tensor, src: torch.Tensor) -> None:
    """dst[:, :, f, h, w] = src[:, :, f // rf, h // rh, w // rw]: a nearest
    resize by integer factors, each element of dst written once, in dst's
    own memory order."""
    _, _, Fr, H, W = src.shape
    _, _, f, h, w = dst.shape
    view = dst.unflatten(4, (W, w // W)).unflatten(3, (H, h // H)).unflatten(2, (Fr, f // Fr))
    view.copy_(src[:, :, :, None, :, None, :, None])


def _nearest_resize(x: torch.Tensor, f: int, h: int, w: int, first_alone: bool = False
                    ) -> torch.Tensor:
    """Integer-factor nearest upsampling of [B, C, F, H, W] to (f, h, w).
    ``first_alone``: frame 0 resizes only spatially and the rest fill frames
    1 and on (the causal first frame). A channels-last x gets a channels-last
    output, each element written once; an NCDHW x the plain chain's
    repeat_interleave and concatenation, whose backward the decode with
    gradients keeps."""
    if first_alone and not group_norm.channels_last(x):
        return torch.cat([_nearest_resize(x[:, :, :1], 1, h, w),
                          _nearest_resize(x[:, :, 1:], f - 1, h, w)], dim=2)
    B, C, Fr, H, W = x.shape
    if (f - first_alone) % (Fr - first_alone) or h % H or w % W:
        raise ValueError(f"non-integer resize {tuple(x.shape)} -> {(f, h, w)}")
    if not group_norm.channels_last(x):
        if f != Fr:
            x = x.repeat_interleave(f // Fr, dim=2)
        if h != H:
            x = x.repeat_interleave(h // H, dim=3)
        if w != W:
            x = x.repeat_interleave(w // W, dim=4)
        return x
    out = torch.empty((B, C, f, h, w), dtype=x.dtype, device=x.device,
                      memory_format=CHANNELS_LAST)
    if first_alone:
        _expand_into(out[:, :, :1], x[:, :, :1])
        _expand_into(out[:, :, 1:], x[:, :, 1:])
    else:
        _expand_into(out, x)
    return out


def _nearest_resize_causal(
    z: torch.Tensor, f: int, h: int, w: int, first: bool = True
) -> torch.Tensor:
    """Nearest upsample with the causal first-frame convention: an odd
    target length (>1) upsamples the first frame alone."""
    return _nearest_resize(z, f, h, w, first_alone=first and f > 1 and f % 2 == 1)


def _spatial_norm3d(
    p: SpatialNorm3d, x: torch.Tensor, zq: torch.Tensor, first: bool = True
) -> torch.Tensor:
    """GroupNorm(x) modulated by conv_y/conv_b of the nearest-upsampled
    latent. The 1x1x1 convs commute with nearest upsampling, so they run at
    latent resolution first."""
    _, _, Fr, H, W = x.shape
    conv_y, _ = causal_conv3d(p.conv_y, zq, None)
    conv_b, _ = causal_conv3d(p.conv_b, zq, None)
    conv_y = _nearest_resize_causal(conv_y, Fr, H, W, first)
    conv_b = _nearest_resize_causal(conv_b, Fr, H, W, first)
    return _group_norm(p.norm_layer, x) * conv_y + conv_b


def _norm_silu(
    p: nn.GroupNorm | SpatialNorm3d, x: torch.Tensor, zq: torch.Tensor | None = None,
    first: bool = True, lead: int = 0, left: torch.Tensor | None = None,
) -> torch.Tensor:
    """silu(GroupNorm(x)), or with ``zq`` silu(SpatialNorm3d(x, zq)): the
    kernel on the card's route, else the plain chain (module docstring).
    ``lead``: the result is the next causal conv's input, its ``lead`` left
    frames in front: ``left`` (the conv's cache) or, where None, frame 0
    repeated. The kernel writes them in place; the plain chain concatenates."""
    obs.count("vae.norm_n", 1)
    norm = p if zq is None else p.norm_layer
    if not _on_card(x, p, zq=zq):
        h = F.silu(_group_norm(p, x) if zq is None else _spatial_norm3d(p, x, zq, first))
        if not lead:
            return h
        left = h[:, :, :1].expand(-1, -1, lead, -1, -1) if left is None else left.to(h.dtype)
        return torch.cat([left, h], dim=2)
    cy = cb = None
    if zq is not None:
        cy, _ = causal_conv3d(p.conv_y, zq, None)
        cb, _ = causal_conv3d(p.conv_b, zq, None)
    obs.count("vae.norm_fused_n", 1)
    return group_norm.group_norm_silu_launch(
        x, norm.num_groups, norm.weight, norm.bias, norm.eps, cy, cb, first, lead, left)


def _norm_conv(
    pn: nn.GroupNorm | SpatialNorm3d, pc: CausalConv3d, x: torch.Tensor,
    zq: torch.Tensor | None, first: bool, cache: Cache, new_cache: Cache, key: str,
    keep_cache: bool,
) -> torch.Tensor:
    """causal_conv3d(pc, silu(norm(x))) under the conv-cache key ``key``:
    the norm hands the conv its input with the left frames in front."""
    conv = pc.conv
    kt = conv.kt if isinstance(conv, quant.QConv3d) else conv.weight.shape[2]
    h = _norm_silu(pn, x, zq, first, kt - 1, cache.get(key))
    y, new_cache[key] = causal_conv3d(pc, h, None, keep_cache, name=key, framed=True)
    return y


def _resnet(
    p: ResnetBlock3d, x: torch.Tensor, zq: torch.Tensor | None, cache: Cache,
    new_cache: Cache, path: str, first: bool, keep_cache: bool,
) -> torch.Tensor:
    h = _norm_conv(p.norm1, p.conv1, x, zq, first, cache, new_cache, f"{path}.conv1",
                   keep_cache)
    h = _norm_conv(p.norm2, p.conv2, h, zq, first, cache, new_cache, f"{path}.conv2",
                   keep_cache)
    if p.conv_shortcut is not None:
        x, _ = causal_conv3d(p.conv_shortcut, x, None, name=f"{path}.conv_shortcut")
    return x + h


def _downsample(
    p: Conv2dHolder, x: torch.Tensor, compress_time: bool, name: str | None = None,
) -> torch.Tensor:
    """Spatial stride-2 conv with (0,1) asymmetric pad; optional 2x temporal
    mean-pool with causal first-frame passthrough on odd lengths."""
    # in memory order: NDHWC on the card's route (frames dim 1), else NCDHW
    cl = group_norm.channels_last(x)
    v, t = (x.permute(0, 2, 3, 4, 1), 1) if cl else (x, 2)
    if compress_time:
        Fr = v.shape[t]
        if Fr % 2 == 1:
            first, rest = v.narrow(t, 0, 1), v.narrow(t, 1, Fr - 1)
            if Fr > 1:
                rest = rest.unflatten(t, ((Fr - 1) // 2, 2)).mean(dim=t + 1)
            v = torch.cat([first, rest], dim=t)
        else:
            v = v.unflatten(t, (Fr // 2, 2)).mean(dim=t + 1)
    v = F.pad(v, (0, 0, 0, 1, 0, 1) if cl else (0, 1, 0, 1))
    x = v.permute(0, 4, 1, 2, 3) if cl else v
    return _conv_per_frame(p, x, stride=2, padding=0, name=name)


def _upsample(
    p: Conv2dHolder, x: torch.Tensor, compress_time: bool, first: bool = True,
    name: str | None = None,
) -> torch.Tensor:
    """2x nearest upsample (spatial, and temporal when compress_time) + conv.

    The clip's first frame (an odd segment length at a clip start) doubles
    only spatially; in a continuation segment every frame doubles."""
    _, _, Fr, H, W = x.shape
    if compress_time:
        if first and Fr > 1 and Fr % 2 == 1:
            x = _nearest_resize(x, 2 * Fr - 1, H * 2, W * 2, first_alone=True)
        elif Fr > 1 or not first:
            x = _nearest_resize(x, Fr * 2, H * 2, W * 2)
        else:
            x = _nearest_resize(x, 1, H * 2, W * 2)
    else:
        x = _nearest_resize(x, Fr, H * 2, W * 2)
    return _conv_per_frame(p, x, stride=1, padding=1, name=name)


# ---------------------------------------------------------------------------
# Encoder / decoder (one chunk, cache-threaded; [B, C, F, H, W] in and out,
# channels-last out on the card's route)
# ---------------------------------------------------------------------------

def encoder_forward(
    cfg: VAEConfig, enc: Encoder, x: torch.Tensor, cache: Cache | None,
    keep_cache: bool = True,
) -> tuple[torch.Tensor, Cache]:
    """Pixels [B, 3, F, H, W] -> moments [B, 2*latent, F', H/8, W/8]."""
    _set_scope("encoder")
    cache = cache or {}
    nc: Cache = {}
    h, nc["conv_in"] = causal_conv3d(enc.conv_in, x, cache.get("conv_in"), keep_cache,
                                     name="conv_in")
    n_blocks = len(cfg.block_out_channels)
    for i, level in enumerate(enc.down_blocks):
        for j, res in enumerate(level.resnets):
            h = _resnet(res, h, None, cache, nc, f"down.{i}.res.{j}", True, keep_cache)
        if i < n_blocks - 1:
            h = _downsample(level.downsamplers[0], h, i < cfg.temporal_compress_level,
                            name=f"down.{i}.downsample")
    for j, res in enumerate(enc.mid_block.resnets):
        h = _resnet(res, h, None, cache, nc, f"mid.{j}", True, keep_cache)
    h = _norm_conv(enc.norm_out, enc.conv_out, h, None, True, cache, nc, "conv_out",
                   keep_cache)
    return h, nc


def decoder_forward(
    cfg: VAEConfig, dec: Decoder, z: torch.Tensor, cache: Cache | None,
    keep_cache: bool = True, remat: bool = False,
) -> tuple[torch.Tensor, Cache]:
    """Latent [B, latent, F', h, w] -> pixels [B, 3, F, H, W] in [-1, 1].

    ``cache is None`` marks the clip's first segment (its leading latent is
    the causally special first frame); with a cache this is a continuation
    segment: uniform temporal upsampling, conv left context from the cache.

    ``remat`` checkpoints each decoder LEVEL (the mid block, then each up
    level with its upsampler; ``torch.utils.checkpoint``, non-reentrant), as
    the JAX package does: the backward of a decode with gradients then keeps
    the level inputs, 4-16x coarser than the full-resolution activations a
    per-resnet checkpoint would keep, and recomputes one level at a time.
    The conv cache a level writes is taken from its forward's return value;
    the recompute writes a dict of its own that is dropped, so the cache
    holds none of the recompute's tensors."""
    _set_scope("decoder")
    first = cache is None
    cache = cache or {}
    nc: Cache = {}
    if _on_card(z, dec):  # one channels-last copy of the latent for its 1x1x1 convs
        z = z.contiguous(memory_format=CHANNELS_LAST)

    def run_level(fn, h: torch.Tensor) -> torch.Tensor:
        if not remat:
            return fn(h, z, nc)

        def pure(hh, zz):
            nc2: Cache = {}
            return fn(hh, zz, nc2), nc2

        h, nc2 = checkpoint(pure, h, z, use_reentrant=False)
        nc.update(nc2)
        return h

    h, nc["conv_in"] = causal_conv3d(dec.conv_in, z, cache.get("conv_in"), keep_cache,
                                     name="conv_in")

    def mid_level(h, zq, nc2):
        for j, res in enumerate(dec.mid_block.resnets):
            h = _resnet(res, h, zq, cache, nc2, f"mid.{j}", first, keep_cache)
        return h

    h = run_level(mid_level, h)
    n_blocks = len(cfg.block_out_channels)
    for i, level in enumerate(dec.up_blocks):
        def up_level(h, zq, nc2, i=i, level=level):
            for j, res in enumerate(level.resnets):
                h = _resnet(res, h, zq, cache, nc2, f"up.{i}.res.{j}", first, keep_cache)
            if i < n_blocks - 1:
                h = _upsample(level.upsamplers[0], h, i < cfg.temporal_compress_level,
                              first, name=f"up.{i}.upsample")
            return h

        h = run_level(up_level, h)
    h = _norm_conv(dec.norm_out, dec.conv_out, h, z, first, cache, nc, "conv_out", keep_cache)
    return h, nc


# ---------------------------------------------------------------------------
# Frame-chunked ("sliced") encode / decode, [B, F, H, W, C] in and out
# ---------------------------------------------------------------------------

def _frame_chunks(num_frames: int, batch: int) -> list[tuple[int, int]]:
    """Chunk layout: the F % batch remainder rides with the FIRST chunk, so
    the first chunk carries the causal odd frame ((F-1) % 4 == 0 inputs)."""
    num_batches = max(num_frames // batch, 1)
    rem = num_frames % batch
    spans = []
    for i in range(num_batches):
        start = batch * i + (0 if i == 0 else rem)
        end = batch * (i + 1) + rem
        spans.append((start, min(end, num_frames)))
    return spans


def encode_moments_cached(
    cfg: VAEConfig,
    vae: AutoencoderKLCogVideoX,
    video: torch.Tensor,
    cache: Cache | None,
    chunk_frames: int | None = None,
    return_cache: bool = True,
) -> tuple[torch.Tensor, Cache | None]:
    """Segment encode threading the causal conv cache across calls.

    video: [B, F, H, W, 3] in [-1, 1] -> moments [B, F', H/8, W/8, 2C]. The
    first segment of a clip passes ``cache=None``; a continuation segment
    passes the previous call's cache and must hold a multiple of the
    temporal ratio in frames."""
    if cache is not None and video.shape[1] % cfg.temporal_compression_ratio:
        raise ValueError(
            "continuation segments must be a multiple of the temporal ratio, "
            f"got {video.shape[1]} frames"
        )
    chunk = chunk_frames or cfg.sample_frames_batch_size
    x = video.permute(0, 4, 1, 2, 3)
    spans = _frame_chunks(video.shape[1], chunk)
    outs = []
    for n, (s, e) in enumerate(spans):
        keep = return_cache or n < len(spans) - 1
        m, cache = encoder_forward(cfg, vae.encoder, x[:, :, s:e], cache, keep)
        outs.append(m)
    moments = outs[0] if len(outs) == 1 else torch.cat(outs, dim=2)
    return moments.permute(0, 2, 3, 4, 1), (cache if return_cache else None)


def encode_moments(
    cfg: VAEConfig, vae: AutoencoderKLCogVideoX, video: torch.Tensor,
    chunk_frames: int | None = None,
) -> torch.Tensor:
    """Full-clip encode with frame chunking. video: [B, F, H, W, 3] in [-1,1]."""
    moments, _ = encode_moments_cached(cfg, vae, video, None, chunk_frames,
                                       return_cache=False)
    return moments


def sample_latent(
    moments: torch.Tensor, generator: torch.Generator | None, scaling_factor: float,
    part: tuple[int, int] | None = None,
) -> torch.Tensor:
    """Diagonal-Gaussian sample (or the mean when generator is None), scaled.
    ``part`` (i, n): ``moments`` is part i of a batch cut into n equal parts
    (a data-parallel rank's share); the generator draws the whole batch's
    noise, as one process would, and this part takes its slice."""
    mean, logvar = moments.chunk(2, dim=-1)
    if generator is not None:
        std = torch.exp(0.5 * logvar.float().clamp(-30.0, 20.0))
        eps = draw_part(std.shape, generator, std.device, part)
        mean = mean + (std * eps).to(mean.dtype)
    return mean * torch.tensor(scaling_factor, dtype=mean.dtype)


def draw_part(shape: tuple, generator: torch.Generator, device,
              part: tuple[int, int] | None = None) -> torch.Tensor:
    """fp32 normals of ``shape``; with ``part`` (i, n), the i-th batch slice
    of the normals of the whole batch (n times ``shape[0]`` rows)."""
    if part is None:
        return torch.randn(shape, generator=generator, device=device, dtype=torch.float32)
    i, n = part
    eps = torch.randn((shape[0] * n,) + tuple(shape[1:]), generator=generator,
                      device=device, dtype=torch.float32)
    return eps.narrow(0, i * shape[0], shape[0])


def decode_cached(
    cfg: VAEConfig,
    vae: AutoencoderKLCogVideoX,
    latent: torch.Tensor,
    cache: Cache | None,
    chunk_frames: int | None = None,
    return_cache: bool = True,
    remat: bool = False,
) -> tuple[torch.Tensor, Cache | None]:
    """Segment decode threading the causal conv cache across calls.
    latent: [B, F', h, w, C] (already divided by scaling_factor) ->
    pixels [B, F, H, W, 3]. ``remat``: see :func:`decoder_forward`."""
    chunk = chunk_frames or cfg.latent_frames_batch_size
    z = latent.permute(0, 4, 1, 2, 3)
    spans = _frame_chunks(latent.shape[1], chunk)
    outs = []
    for n, (s, e) in enumerate(spans):
        keep = return_cache or n < len(spans) - 1
        y, cache = decoder_forward(cfg, vae.decoder, z[:, :, s:e], cache, keep, remat)
        outs.append(y)
    pixels = outs[0] if len(outs) == 1 else torch.cat(outs, dim=2)
    return pixels.permute(0, 2, 3, 4, 1), (cache if return_cache else None)


def decode(
    cfg: VAEConfig, vae: AutoencoderKLCogVideoX, latent: torch.Tensor,
    chunk_frames: int | None = None, remat: bool = False,
) -> torch.Tensor:
    """Full-clip decode with latent-frame chunking. latent: [B, F', h, w, C]
    already divided by scaling_factor. ``remat``: see
    :func:`decoder_forward`."""
    pixels, _ = decode_cached(cfg, vae, latent, None, chunk_frames,
                              return_cache=False, remat=remat)
    return pixels


# ---------------------------------------------------------------------------
# Spatially tiled encode / decode with feathered blending: diffusers'
# AutoencoderKLCogVideoX.enable_tiling() semantics, the VAE's own memory
# tiler (linear feathers in the overlap band), distinct from the pipeline's
# outer exact-coverage tiles (tiling.py). Host-side loops over per-tile calls.
# ---------------------------------------------------------------------------

def _blend_v(a: torch.Tensor, b: torch.Tensor, extent: int) -> torch.Tensor:
    """Linear vertical feather: blend b's top `extent` rows with a's bottom."""
    extent = min(a.shape[2], b.shape[2], extent)
    if extent <= 0:
        return b
    w = (torch.arange(extent, dtype=torch.float32, device=b.device)
         / extent).reshape(1, 1, -1, 1, 1)
    top = a[:, :, -extent:].float() * (1 - w) + b[:, :, :extent].float() * w
    return torch.cat([top.to(b.dtype), b[:, :, extent:]], dim=2)


def _blend_h(a: torch.Tensor, b: torch.Tensor, extent: int) -> torch.Tensor:
    """Linear horizontal feather: blend b's left `extent` cols with a's right."""
    extent = min(a.shape[3], b.shape[3], extent)
    if extent <= 0:
        return b
    w = (torch.arange(extent, dtype=torch.float32, device=b.device)
         / extent).reshape(1, 1, 1, -1, 1)
    left = a[:, :, :, -extent:].float() * (1 - w) + b[:, :, :, :extent].float() * w
    return torch.cat([left.to(b.dtype), b[:, :, :, extent:]], dim=3)


def _assemble_rows(rows, blend_h: int, blend_w: int, row_limit_h: int,
                   row_limit_w: int, out_h: int, out_w: int) -> torch.Tensor:
    """Feather each tile into its upper and left neighbours, crop it to the
    stride grid and concatenate: [B, F, out_h, out_w, C]."""
    result_rows = []
    for i, row in enumerate(rows):
        out_row = []
        for j, tile in enumerate(row):
            if i > 0:
                tile = _blend_v(rows[i - 1][j], tile, blend_h)
            if j > 0:
                tile = _blend_h(row[j - 1], tile, blend_w)
            out_row.append(tile[:, :, :row_limit_h, :row_limit_w])
        result_rows.append(torch.cat(out_row, dim=3))
    return torch.cat(result_rows, dim=2)[:, :, :out_h, :out_w]


def tiled_encode_moments(
    cfg: VAEConfig, vae: AutoencoderKLCogVideoX, video: torch.Tensor,
    chunk_frames: int | None = None, encode_fn=None,
) -> torch.Tensor:
    """Tiled full-clip encode. video: [B, F, H, W, 3] -> moments (feathered).

    encode_fn overrides the per-tile encoder (tile -> moments)."""
    if encode_fn is None:
        encode_fn = lambda tile: encode_moments(cfg, vae, tile, chunk_frames)  # noqa: E731
    H, W = video.shape[2], video.shape[3]
    s = cfg.spatial_scale
    tile_h, tile_w = cfg.tile_sample_min_height, cfg.tile_sample_min_width
    if H <= tile_h and W <= tile_w:
        return encode_fn(video)
    lat_h, lat_w = tile_h // s, tile_w // s
    # the sampling stride derives from the placement size (latents * s), so
    # sampled and assembled tile positions align exactly
    blend_h, stride_h = cfg.tile_geometry(lat_h, cfg.tile_overlap_factor_height)
    blend_w, stride_w = cfg.tile_geometry(lat_w, cfg.tile_overlap_factor_width)
    rows = [
        [encode_fn(video[:, :, i:i + tile_h, j:j + tile_w])
         for j in range(0, W, stride_w * s)]
        for i in range(0, H, stride_h * s)
    ]
    return _assemble_rows(rows, blend_h, blend_w, lat_h - blend_h,
                          lat_w - blend_w, H // s, W // s)


def _decode_tile_geometry(cfg: VAEConfig):
    """(lat_h, lat_w, blend_lat_h, stride_h, blend_lat_w, stride_w) of the
    tiled decode, in latents."""
    s = cfg.spatial_scale
    lat_h = cfg.decode_tile_latent_height or cfg.tile_sample_min_height // s
    lat_w = cfg.decode_tile_latent_width or cfg.tile_sample_min_width // s
    blend_h, stride_h = cfg.tile_geometry(lat_h, cfg.tile_overlap_factor_height)
    blend_w, stride_w = cfg.tile_geometry(lat_w, cfg.tile_overlap_factor_width)
    return lat_h, lat_w, blend_h, stride_h, blend_w, stride_w


def tiled_decode(
    cfg: VAEConfig, vae: AutoencoderKLCogVideoX, latent: torch.Tensor,
    chunk_frames: int | None = None, decode_fn=None,
) -> torch.Tensor:
    """Tiled full-clip decode. latent: [B, F', h, w, C] (unscaled) -> pixels."""
    if decode_fn is None:
        decode_fn = lambda tile: decode(cfg, vae, tile, chunk_frames)  # noqa: E731
    h, w = latent.shape[2], latent.shape[3]
    s = cfg.spatial_scale
    lat_h, lat_w, blend_h, stride_h, blend_w, stride_w = _decode_tile_geometry(cfg)
    if h <= lat_h and w <= lat_w:
        return decode_fn(latent)
    rows = [
        [decode_fn(latent[:, :, i:i + lat_h, j:j + lat_w])
         for j in range(0, w, stride_w)]
        for i in range(0, h, stride_h)
    ]
    return _assemble_rows(rows, blend_h * s, blend_w * s, (lat_h - blend_h) * s,
                          (lat_w - blend_w) * s, h * s, w * s)


# ---------------------------------------------------------------------------
# Initialization (random weights; checkpoints load via weights.py)
# ---------------------------------------------------------------------------

@torch.no_grad()
def init_vae_params(
    cfg: VAEConfig, seed: int = 1, device="cpu", dtype=torch.float32
) -> AutoencoderKLCogVideoX:
    """A VAE with seeded random weights, the distribution of the JAX
    package's ``init_vae_params``: conv weights uniform in +-1/sqrt(fan_in),
    biases 0, GroupNorm gains 1 and biases 0."""
    with torch.device("meta"):
        vae = AutoencoderKLCogVideoX(cfg, dtype=dtype)
    vae = vae.to_empty(device=device)
    gen = torch.Generator(device=device).manual_seed(seed)
    for mod in vae.modules():
        if isinstance(mod, (nn.Conv2d, nn.Conv3d)):
            fan_in = math.prod(mod.weight.shape[1:])
            bound = 1.0 / math.sqrt(fan_in)
            mod.weight.uniform_(-bound, bound, generator=gen)
            mod.bias.zero_()
        elif isinstance(mod, nn.GroupNorm):
            mod.weight.fill_(1.0)
            mod.bias.zero_()
    return vae.eval().requires_grad_(False)
