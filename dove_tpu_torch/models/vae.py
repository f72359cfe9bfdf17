"""CogVideoX 3D causal VAE (bf16/fp32) in PyTorch.

Counterpart of ``dove_tpu/models/vae.py`` without its int8, calibration,
error-attribution and Pallas branches, and without the ``tiled_*`` and
``*_host`` APIs:

  * 8x spatial / 4x temporal compression, 16 latent channels;
  * causal 3D convs: at a clip's start the first frame is replicated as
    temporal left padding; chunked processing threads a cache of every
    causal conv's trailing k_t-1 input frames, so chunked and whole-clip
    results agree;
  * encoder temporal mean-pool and decoder temporal upsampling treat an odd
    leading frame as the clip's causal first frame.

The parameters live in ``nn.Module``s named like the diffusers checkpoint
(``encoder.down_blocks.0.resnets.1.conv1.conv.weight``, ...), so a released
state dict loads with ``load_state_dict``. The forward code is functional
over those modules. Public functions keep the JAX package's [B, F, H, W, C]
layout; inside, activations are NCDHW, the layout cuDNN's 3D convolution
takes. GroupNorm takes its statistics in fp32 and applies the affine in the
model dtype, as the JAX package does.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from dove_tpu_torch.config import VAEConfig

Cache = dict[str, torch.Tensor]


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
# Primitives (activations NCDHW)
# ---------------------------------------------------------------------------

def causal_conv3d(
    p: CausalConv3d | nn.Conv3d, x: torch.Tensor, cache: torch.Tensor | None,
    keep_cache: bool = True,
) -> tuple[torch.Tensor, torch.Tensor | None]:
    """Causal 3D conv: temporal left context from ``cache`` (or first-frame
    replicate at clip start), symmetric zero spatial padding.

    Returns (output, new_cache): the trailing k_t-1 input frames for the next
    chunk (a copy, so it does not keep the padded input alive), or None when
    k_t == 1 or the caller does not keep caches."""
    conv = p.conv if isinstance(p, CausalConv3d) else p
    kt, kh, kw = conv.weight.shape[2:]
    new_cache = None
    if kt > 1:
        if cache is None:
            left = x[:, :, :1].expand(-1, -1, kt - 1, -1, -1)
        else:
            left = cache.to(x.dtype)
        x = torch.cat([left, x], dim=2)
        if keep_cache:
            new_cache = x[:, :, -(kt - 1):].clone()
    y = F.conv3d(x, conv.weight, conv.bias, padding=(0, (kh - 1) // 2, (kw - 1) // 2))
    return y, new_cache


def _conv_per_frame(p: Conv2dHolder, x: torch.Tensor, stride: int, padding: int) -> torch.Tensor:
    """The down/upsampler's 2D conv on every frame, as a k_t=1 3D conv."""
    w = p.conv.weight.unsqueeze(2)
    return F.conv3d(x, w, p.conv.bias, stride=(1, stride, stride),
                    padding=(0, padding, padding))


def _group_norm(p: nn.GroupNorm, x: torch.Tensor) -> torch.Tensor:
    """GroupNorm with fp32 statistics (torch's group_norm accumulates bf16
    input in fp32 and rounds once); the affine runs in the model dtype."""
    y = F.group_norm(x, p.num_groups, eps=p.eps)
    shape = (1, -1) + (1,) * (x.ndim - 2)
    return y * p.weight.to(x.dtype).view(shape) + p.bias.to(x.dtype).view(shape)


def _nearest_resize(x: torch.Tensor, f: int, h: int, w: int) -> torch.Tensor:
    """Integer-factor nearest upsampling of [B, C, F, H, W] to (f, h, w)."""
    _, _, Fr, H, W = x.shape
    if f % Fr or h % H or w % W:
        raise ValueError(f"non-integer resize {tuple(x.shape)} -> {(f, h, w)}")
    if f != Fr:
        x = x.repeat_interleave(f // Fr, dim=2)
    if h != H:
        x = x.repeat_interleave(h // H, dim=3)
    if w != W:
        x = x.repeat_interleave(w // W, dim=4)
    return x


def _nearest_resize_causal(
    z: torch.Tensor, f: int, h: int, w: int, first: bool = True
) -> torch.Tensor:
    """Nearest upsample with the causal first-frame convention: an odd
    target length (>1) upsamples the first frame alone."""
    if first and f > 1 and f % 2 == 1:
        zf = _nearest_resize(z[:, :, :1], 1, h, w)
        zr = _nearest_resize(z[:, :, 1:], f - 1, h, w)
        return torch.cat([zf, zr], dim=2)
    return _nearest_resize(z, f, h, w)


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


def _resnet(
    p: ResnetBlock3d, x: torch.Tensor, zq: torch.Tensor | None, cache: Cache,
    new_cache: Cache, path: str, first: bool, keep_cache: bool,
) -> torch.Tensor:
    def norm(m: nn.Module, h: torch.Tensor) -> torch.Tensor:
        if zq is None:
            return _group_norm(m, h)
        return _spatial_norm3d(m, h, zq, first)

    h = F.silu(norm(p.norm1, x))
    h, new_cache[f"{path}.conv1"] = causal_conv3d(
        p.conv1, h, cache.get(f"{path}.conv1"), keep_cache
    )
    h = F.silu(norm(p.norm2, h))
    h, new_cache[f"{path}.conv2"] = causal_conv3d(
        p.conv2, h, cache.get(f"{path}.conv2"), keep_cache
    )
    if p.conv_shortcut is not None:
        x, _ = causal_conv3d(p.conv_shortcut, x, None)
    return x + h


def _downsample(p: Conv2dHolder, x: torch.Tensor, compress_time: bool) -> torch.Tensor:
    """Spatial stride-2 conv with (0,1) asymmetric pad; optional 2x temporal
    mean-pool with causal first-frame passthrough on odd lengths."""
    if compress_time:
        B, C, Fr, H, W = x.shape
        if Fr % 2 == 1:
            first, rest = x[:, :, :1], x[:, :, 1:]
            if rest.shape[2] > 0:
                rest = rest.reshape(B, C, rest.shape[2] // 2, 2, H, W).mean(dim=3)
            x = torch.cat([first, rest], dim=2)
        else:
            x = x.reshape(B, C, Fr // 2, 2, H, W).mean(dim=3)
    x = F.pad(x, (0, 1, 0, 1))
    return _conv_per_frame(p, x, stride=2, padding=0)


def _upsample(
    p: Conv2dHolder, x: torch.Tensor, compress_time: bool, first: bool = True
) -> torch.Tensor:
    """2x nearest upsample (spatial, and temporal when compress_time) + conv.

    The clip's first frame (an odd segment length at a clip start) doubles
    only spatially; in a continuation segment every frame doubles."""
    _, _, Fr, H, W = x.shape
    if compress_time:
        if first and Fr > 1 and Fr % 2 == 1:
            head = _nearest_resize(x[:, :, :1], 1, H * 2, W * 2)
            rest = _nearest_resize(x[:, :, 1:], (Fr - 1) * 2, H * 2, W * 2)
            x = torch.cat([head, rest], dim=2)
        elif Fr > 1 or not first:
            x = _nearest_resize(x, Fr * 2, H * 2, W * 2)
        else:
            x = _nearest_resize(x, 1, H * 2, W * 2)
    else:
        x = _nearest_resize(x, Fr, H * 2, W * 2)
    return _conv_per_frame(p, x, stride=1, padding=1)


# ---------------------------------------------------------------------------
# Encoder / decoder (one chunk, cache-threaded; NCDHW in and out)
# ---------------------------------------------------------------------------

def encoder_forward(
    cfg: VAEConfig, enc: Encoder, x: torch.Tensor, cache: Cache | None,
    keep_cache: bool = True,
) -> tuple[torch.Tensor, Cache]:
    """Pixels [B, 3, F, H, W] -> moments [B, 2*latent, F', H/8, W/8]."""
    cache = cache or {}
    nc: Cache = {}
    h, nc["conv_in"] = causal_conv3d(enc.conv_in, x, cache.get("conv_in"), keep_cache)
    n_blocks = len(cfg.block_out_channels)
    for i, level in enumerate(enc.down_blocks):
        for j, res in enumerate(level.resnets):
            h = _resnet(res, h, None, cache, nc, f"down.{i}.res.{j}", True, keep_cache)
        if i < n_blocks - 1:
            h = _downsample(level.downsamplers[0], h, i < cfg.temporal_compress_level)
    for j, res in enumerate(enc.mid_block.resnets):
        h = _resnet(res, h, None, cache, nc, f"mid.{j}", True, keep_cache)
    h = F.silu(_group_norm(enc.norm_out, h))
    h, nc["conv_out"] = causal_conv3d(enc.conv_out, h, cache.get("conv_out"), keep_cache)
    return h, nc


def decoder_forward(
    cfg: VAEConfig, dec: Decoder, z: torch.Tensor, cache: Cache | None,
    keep_cache: bool = True,
) -> tuple[torch.Tensor, Cache]:
    """Latent [B, latent, F', h, w] -> pixels [B, 3, F, H, W] in [-1, 1].

    ``cache is None`` marks the clip's first segment (its leading latent is
    the causally special first frame); with a cache this is a continuation
    segment: uniform temporal upsampling, conv left context from the cache."""
    first = cache is None
    cache = cache or {}
    nc: Cache = {}
    h, nc["conv_in"] = causal_conv3d(dec.conv_in, z, cache.get("conv_in"), keep_cache)
    for j, res in enumerate(dec.mid_block.resnets):
        h = _resnet(res, h, z, cache, nc, f"mid.{j}", first, keep_cache)
    n_blocks = len(cfg.block_out_channels)
    for i, level in enumerate(dec.up_blocks):
        for j, res in enumerate(level.resnets):
            h = _resnet(res, h, z, cache, nc, f"up.{i}.res.{j}", first, keep_cache)
        if i < n_blocks - 1:
            h = _upsample(level.upsamplers[0], h, i < cfg.temporal_compress_level, first)
    h = F.silu(_spatial_norm3d(dec.norm_out, h, z, first))
    h, nc["conv_out"] = causal_conv3d(dec.conv_out, h, cache.get("conv_out"), keep_cache)
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
    moments: torch.Tensor, generator: torch.Generator | None, scaling_factor: float
) -> torch.Tensor:
    """Diagonal-Gaussian sample (or the mean when generator is None), scaled."""
    mean, logvar = moments.chunk(2, dim=-1)
    if generator is not None:
        std = torch.exp(0.5 * logvar.float().clamp(-30.0, 20.0))
        eps = torch.randn(std.shape, generator=generator, device=std.device,
                          dtype=torch.float32)
        mean = mean + (std * eps).to(mean.dtype)
    return mean * torch.tensor(scaling_factor, dtype=mean.dtype)


def decode_cached(
    cfg: VAEConfig,
    vae: AutoencoderKLCogVideoX,
    latent: torch.Tensor,
    cache: Cache | None,
    chunk_frames: int | None = None,
    return_cache: bool = True,
) -> tuple[torch.Tensor, Cache | None]:
    """Segment decode threading the causal conv cache across calls.
    latent: [B, F', h, w, C] (already divided by scaling_factor) ->
    pixels [B, F, H, W, 3]."""
    chunk = chunk_frames or cfg.latent_frames_batch_size
    z = latent.permute(0, 4, 1, 2, 3)
    spans = _frame_chunks(latent.shape[1], chunk)
    outs = []
    for n, (s, e) in enumerate(spans):
        keep = return_cache or n < len(spans) - 1
        y, cache = decoder_forward(cfg, vae.decoder, z[:, :, s:e], cache, keep)
        outs.append(y)
    pixels = outs[0] if len(outs) == 1 else torch.cat(outs, dim=2)
    return pixels.permute(0, 2, 3, 4, 1), (cache if return_cache else None)


def decode(
    cfg: VAEConfig, vae: AutoencoderKLCogVideoX, latent: torch.Tensor,
    chunk_frames: int | None = None,
) -> torch.Tensor:
    """Full-clip decode with latent-frame chunking. latent: [B, F', h, w, C]
    already divided by scaling_factor."""
    pixels, _ = decode_cached(cfg, vae, latent, None, chunk_frames,
                              return_cache=False)
    return pixels


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
