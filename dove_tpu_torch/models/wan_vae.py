"""Wan2.1's causal video VAE (``WanVAE_``) as a PyTorch module.

The public code is ``wan/modules/vae.py`` of github.com/Wan-AI/Wan2.1
(``_video_vae``: base 96, z 16, mults (1, 2, 4, 4), 2 residual blocks a
level, no attention scales, temporal downsampling (False, True, True));
module and parameter names follow it (``encoder.downsamples.{i}.residual.
{0,2,3,6}``, ``decoder.upsamples.{i}.time_conv``, ``conv1``, ``conv2``, ...),
so ``Wan2.1_VAE.pth`` loads with ``load_state_dict``.

Pieces:

  * ``RMS_norm``: ``F.normalize`` over the channels times sqrt(C) and a gain
    of [C, 1, 1(, 1)], computed here in fp32 (with the SiLU that follows
    it where one does) and rounded once to the model dtype;
  * ``CausalConv3d``: zero padding of one pixel each side in h and w, and
    in time 2 p frames in front: zeros in the first chunk, then the last
    ``CACHE_T`` = 2 input frames of the previous chunk (with one frame in
    the chunk, the previous entry's last frame before it);
  * resamplers on each frame (a (1, 3, 3) conv3d is the release's per-frame
    Conv2d): the encoder's ZeroPad (right, bottom) + stride-2 conv, and
    after levels 1-2 a temporal stride-2 conv over [the previous chunk's
    last frame, this chunk], which the first chunk skips; the decoder's
    temporal conv to 2C channels whose halves interleave into twice the
    frames (skipped by the first chunk, zero-padded in the second, cached
    after), then a nearest 2x and a conv to C / 2;
  * the middle's attention: per frame, one head of C channels over the
    frame's h w positions (``F.scaled_dot_product_attention``: K1 takes
    heads of 64 and 128 only).

``encode`` runs the chunks of 1, 4, 4, ... frames (33 frames: 9 chunks, 9
latent frames) and returns the posterior mean; ``decode`` one latent frame
per chunk. The cache is cleared at each call. Each chunk counts
``vae.chunk_n``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from dove_tpu_torch import obs
from dove_tpu_torch.config import WanVAEConfig

CACHE_T = 2
_REP = "Rep"  # the decoder's temporal upsampler after its first chunk


class _Cache:
    """The per-convolution cache of one encode or decode, walked in call
    order once a chunk."""

    def __init__(self) -> None:
        self.feats: list = []
        self.i = 0

    def get(self):
        return self.feats[self.i] if self.i < len(self.feats) else None

    def put(self, value) -> None:
        if self.i < len(self.feats):
            self.feats[self.i] = value
        else:
            self.feats.append(value)
        self.i += 1


class CausalConv3d(nn.Conv3d):
    """A Conv3d whose time padding is causal: 2 p frames in front, from the
    cache or zeros; h and w zero-padded p each side by the conv itself."""

    def __init__(self, c_in, c_out, kernel, stride=1, padding=0, **kw):
        p = (padding,) * 3 if isinstance(padding, int) else tuple(padding)
        super().__init__(c_in, c_out, kernel, stride=stride, padding=(0, p[1], p[2]), **kw)
        self.front = 2 * p[0]

    def forward(self, x: torch.Tensor, prev: torch.Tensor | None = None) -> torch.Tensor:
        front = self.front
        if front and prev is not None:
            x = torch.cat([prev.to(x.dtype), x], dim=2)
            front -= prev.shape[2]
        if front:
            x = F.pad(x, (0, 0, 0, 0, front, 0))
        return super().forward(x)


def cached_conv(conv: CausalConv3d, x: torch.Tensor, cache: _Cache | None) -> torch.Tensor:
    """``conv`` on a chunk, its cache entry read and replaced by the
    chunk's last ``CACHE_T`` input frames."""
    if cache is None:
        return conv(x)
    prev = cache.get()
    keep = x[:, :, -CACHE_T:].clone()
    if keep.shape[2] < CACHE_T and prev is not None:
        keep = torch.cat([prev[:, :, -1:], keep], dim=2)
    out = conv(x, prev)
    cache.put(keep)
    return out


class RMS_norm(nn.Module):  # noqa: N801 (the release's name)
    def __init__(self, dim: int, images: bool = True, **kw):
        super().__init__()
        self.scale = dim ** 0.5
        shape = (dim, 1, 1) if images else (dim, 1, 1, 1)
        self.gamma = nn.Parameter(torch.ones(shape, **kw))

    def forward(self, x: torch.Tensor, silu: bool = False) -> torch.Tensor:
        xf = x.float()
        norm = torch.linalg.vector_norm(xf, dim=1, keepdim=True).clamp_min(1e-12)
        y = xf / norm * (self.gamma.float() * self.scale)
        return (F.silu(y) if silu else y).to(x.dtype)


class ResidualBlock(nn.Module):
    def __init__(self, c_in: int, c_out: int, **kw):
        super().__init__()
        self.residual = nn.Sequential(
            RMS_norm(c_in, images=False, **kw), nn.SiLU(),
            CausalConv3d(c_in, c_out, 3, padding=1, **kw),
            RMS_norm(c_out, images=False, **kw), nn.SiLU(), nn.Dropout(0.0),
            CausalConv3d(c_out, c_out, 3, padding=1, **kw))
        self.shortcut = CausalConv3d(c_in, c_out, 1, **kw) if c_in != c_out else nn.Identity()

    def forward(self, x: torch.Tensor, cache: _Cache | None = None) -> torch.Tensor:
        h = self.shortcut(x)
        r = self.residual
        y = cached_conv(r[2], r[0](x, silu=True), cache)
        y = cached_conv(r[6], r[3](y, silu=True), cache)
        return y + h


class AttentionBlock(nn.Module):
    """One head of C channels over each frame's positions."""

    def __init__(self, dim: int, **kw):
        super().__init__()
        self.norm = RMS_norm(dim, **kw)
        self.to_qkv = nn.Conv2d(dim, 3 * dim, 1, **kw)
        self.proj = nn.Conv2d(dim, dim, 1, **kw)

    def forward(self, x: torch.Tensor, cache: _Cache | None = None) -> torch.Tensor:
        b, c, t, h, w = x.shape
        y = self.norm(x.transpose(1, 2).reshape(b * t, c, h, w))
        qkv = F.conv2d(y, self.to_qkv.weight, self.to_qkv.bias)
        q, k, v = qkv.reshape(b * t, 1, 3 * c, h * w).transpose(2, 3).chunk(3, dim=-1)
        o = F.scaled_dot_product_attention(q.contiguous(), k.contiguous(), v.contiguous())
        o = o.squeeze(1).transpose(1, 2).reshape(b * t, c, h, w)
        o = F.conv2d(o, self.proj.weight, self.proj.bias)
        return x + o.reshape(b, t, c, h, w).transpose(1, 2)


def _frame_conv(conv: nn.Conv2d, x: torch.Tensor, stride: int, pad: int) -> torch.Tensor:
    """The release's per-frame Conv2d on [B, C, T, H, W], as a (1, k, k) conv3d."""
    return F.conv3d(x, conv.weight.unsqueeze(2), conv.bias, stride=(1, stride, stride),
                    padding=(0, pad, pad))


class Resample(nn.Module):
    def __init__(self, dim: int, mode: str, **kw):
        super().__init__()
        self.mode = mode
        if mode.startswith("upsample"):
            self.resample = nn.Sequential(nn.Upsample(scale_factor=(2.0, 2.0), mode="nearest"),
                                          nn.Conv2d(dim, dim // 2, 3, padding=1, **kw))
        else:
            self.resample = nn.Sequential(nn.ZeroPad2d((0, 1, 0, 1)),
                                          nn.Conv2d(dim, dim, 3, stride=2, **kw))
        if mode == "upsample3d":
            self.time_conv = CausalConv3d(dim, 2 * dim, (3, 1, 1), padding=(1, 0, 0), **kw)
        elif mode == "downsample3d":
            self.time_conv = CausalConv3d(dim, dim, (3, 1, 1), stride=(2, 1, 1), **kw)

    def forward(self, x: torch.Tensor, cache: _Cache | None = None) -> torch.Tensor:
        b, c, t, h, w = x.shape
        if self.mode == "upsample3d" and cache is not None:
            prev = cache.get()
            if prev is None:  # the first chunk keeps its one frame
                cache.put(_REP)
            else:
                keep = x[:, :, -CACHE_T:].clone()
                if keep.shape[2] < CACHE_T:
                    first = (torch.zeros_like(keep) if isinstance(prev, str)
                             else prev[:, :, -1:])
                    keep = torch.cat([first, keep], dim=2)
                x = self.time_conv(x, None if isinstance(prev, str) else prev)
                cache.put(keep)
                x = torch.stack((x[:, :c], x[:, c:]), dim=3).reshape(b, c, 2 * t, h, w)
        if self.mode.startswith("upsample"):
            x = x.repeat_interleave(2, dim=3).repeat_interleave(2, dim=4)
            return _frame_conv(self.resample[1], x, 1, 1)
        x = _frame_conv(self.resample[1], F.pad(x, (0, 1, 0, 1)), 2, 0)
        if self.mode == "downsample3d" and cache is not None:
            prev = cache.get()
            keep = x[:, :, -1:].clone()
            if prev is not None:
                x = self.time_conv(torch.cat([prev, x], dim=2))
            cache.put(keep)
        return x


def _dims(cfg: WanVAEConfig) -> list[int]:
    return [cfg.base_dim * u for u in (1,) + tuple(cfg.dim_mult)]


class Encoder3d(nn.Module):
    def __init__(self, cfg: WanVAEConfig, z_out: int, **kw):
        super().__init__()
        dims = _dims(cfg)
        self.conv1 = CausalConv3d(3, dims[0], 3, padding=1, **kw)
        blocks: list[nn.Module] = []
        n = len(cfg.dim_mult)
        for i, (c_in, c_out) in enumerate(zip(dims[:-1], dims[1:])):
            for _ in range(cfg.num_res_blocks):
                blocks.append(ResidualBlock(c_in, c_out, **kw))
                c_in = c_out
            if i != n - 1:
                mode = "downsample3d" if cfg.temperal_downsample[i] else "downsample2d"
                blocks.append(Resample(c_out, mode, **kw))
        self.downsamples = nn.Sequential(*blocks)
        self.middle = nn.Sequential(ResidualBlock(dims[-1], dims[-1], **kw),
                                    AttentionBlock(dims[-1], **kw),
                                    ResidualBlock(dims[-1], dims[-1], **kw))
        self.head = nn.Sequential(RMS_norm(dims[-1], images=False, **kw), nn.SiLU(),
                                  CausalConv3d(dims[-1], z_out, 3, padding=1, **kw))

    def forward(self, x: torch.Tensor, cache: _Cache | None = None) -> torch.Tensor:
        x = cached_conv(self.conv1, x, cache)
        for layer in self.downsamples:
            x = layer(x, cache)
        for layer in self.middle:
            x = layer(x, cache)
        return cached_conv(self.head[2], self.head[0](x, silu=True), cache)


class Decoder3d(nn.Module):
    def __init__(self, cfg: WanVAEConfig, **kw):
        super().__init__()
        mult = tuple(cfg.dim_mult)
        dims = [cfg.base_dim * u for u in (mult[-1],) + mult[::-1]]
        up = tuple(cfg.temperal_downsample)[::-1]
        self.conv1 = CausalConv3d(cfg.z_dim, dims[0], 3, padding=1, **kw)
        self.middle = nn.Sequential(ResidualBlock(dims[0], dims[0], **kw),
                                    AttentionBlock(dims[0], **kw),
                                    ResidualBlock(dims[0], dims[0], **kw))
        blocks: list[nn.Module] = []
        n = len(mult)
        for i, (c_in, c_out) in enumerate(zip(dims[:-1], dims[1:])):
            if i in (1, 2, 3):
                c_in //= 2
            for _ in range(cfg.num_res_blocks + 1):
                blocks.append(ResidualBlock(c_in, c_out, **kw))
                c_in = c_out
            if i != n - 1:
                blocks.append(Resample(c_out, "upsample3d" if up[i] else "upsample2d", **kw))
        self.upsamples = nn.Sequential(*blocks)
        self.head = nn.Sequential(RMS_norm(dims[-1], images=False, **kw), nn.SiLU(),
                                  CausalConv3d(dims[-1], 3, 3, padding=1, **kw))

    def forward(self, x: torch.Tensor, cache: _Cache | None = None) -> torch.Tensor:
        x = cached_conv(self.conv1, x, cache)
        for layer in self.middle:
            x = layer(x, cache)
        for layer in self.upsamples:
            x = layer(x, cache)
        return cached_conv(self.head[2], self.head[0](x, silu=True), cache)


class WanVAE_(nn.Module):  # noqa: N801 (the release's name)
    """The Wan2.1 VAE: ``encode`` -> the unnormalised posterior mean,
    ``decode`` -> pixels in the model dtype (not yet clamped)."""

    def __init__(self, cfg: WanVAEConfig, device=None, dtype=None):
        super().__init__()
        kw = {"device": device, "dtype": dtype}
        self.cfg = cfg
        z = cfg.z_dim
        self.encoder = Encoder3d(cfg, 2 * z, **kw)
        self.conv1 = CausalConv3d(2 * z, 2 * z, 1, **kw)
        self.conv2 = CausalConv3d(z, z, 1, **kw)
        self.decoder = Decoder3d(cfg, **kw)

    def encode_chunks(self, x: torch.Tensor):
        """x [B, 3, T, H, W] in [-1, 1], (T - 1) % 4 == 0 -> the encoder's
        output of each chunk of 1, 4, 4, ... frames, in order."""
        cache = _Cache()
        T = x.shape[2]
        for i in range(1 + (T - 1) // 4):
            cache.i = 0
            obs.count("vae.chunk_n", 1)
            yield self.encoder(x[:, :, :1] if i == 0 else x[:, :, 4 * i - 3:4 * i + 1], cache)

    def encode(self, x: torch.Tensor) -> torch.Tensor:
        """x [B, 3, T, H, W] -> mu [B, z, 1 + (T - 1) / 4, H / 8, W / 8]."""
        out = torch.cat(list(self.encode_chunks(x)), dim=2)
        return self.conv1(out)[:, :self.cfg.z_dim]

    def decode_chunks(self, z: torch.Tensor):
        """z [B, z_dim, T', h, w] (unnormalised) -> the decoder's pixels of
        each latent frame, in order (1 frame, then 4 a latent)."""
        x = self.conv2(z)
        cache = _Cache()
        for i in range(x.shape[2]):
            cache.i = 0
            obs.count("vae.chunk_n", 1)
            yield self.decoder(x[:, :, i:i + 1], cache)

    def decode(self, z: torch.Tensor) -> torch.Tensor:
        return torch.cat(list(self.decode_chunks(z)), dim=2)


def latent_stats(cfg: WanVAEConfig, device) -> tuple[torch.Tensor, torch.Tensor]:
    """The latent (mean, std) as fp32 [1, z, 1, 1, 1]."""
    shape = (1, cfg.z_dim, 1, 1, 1)
    return (torch.tensor(cfg.latents_mean, dtype=torch.float32, device=device).view(shape),
            torch.tensor(cfg.latents_std, dtype=torch.float32, device=device).view(shape))
