"""DOVE one-step video super-resolution in PyTorch.

Counterpart of ``dove_tpu/pipeline.py`` for bf16 or fp32, unquantized or in
one of the JAX package's five int8 serving modes (``quantize``): the DiT's
linears W8A8 with K2's int8 Q K^T attention (``"int8-dit"``) or weight-only
(``"int8w"``), the VAE's hot convs int8 through K4 (``"int8-vae"``), both
(``"int8"``), or the int8 DiT with an int8 decoder and a float encoder
(``"int8-dit-dec"``). Two paths, as in the JAX package:

The staged path (``vae_tiling=True``, the reference's ``--is_vae_st``, with
no outer tiles). A clip of up to 33 frames is one pass of three stages, run
back to back on the device's stream (the host waits only for the output's
copy to the host):

  * enc: 4x bilinear upscale on the device, VAE encode over feathered
    spatial windows, feathered assembly of the moments;
  * dit: the posterior mean (or a sample), one DiT pass at t=399, and
    x-hat_0 = sqrt(abar) z - sqrt(1-abar) v-hat (train/losses.py);
  * dec: VAE decode over windows, feathered assembly, uint8 RGB or BT.601
    I420.

Longer clips run either as overlapping 33-frame chunks, trimmed at the
overlap midpoints (the reference's temporal stitching), or streamed
(``streaming``; on by default with an int8 DiT): contiguous segments
whose causal conv caches carry across segment calls, so the VAE touches
every frame once, and only the DiT runs on overlapping latent windows. The
window plans are the JAX package's (its 16 GB plans), so seams fall where
they fall there.

The fused outer-tile path (``vae_tiling=False``, the default, or any
``tile_size_hw``): the padded LQ clip is upscaled once (on the device for
the default bilinear mode), cut into overlapping temporal chunks and spatial
tiles (``tiling.plan_tiles``), and each batch of same-shaped tiles runs
:meth:`DovePipeline.sr_tile` (encode, one DiT pass, decode) in one go; the
tiles' trimmed interiors are stitched on the device, every pixel exactly
once, and the clip crosses to the host once, as float in [0, 1].

On the card the DiT's attention takes K1 or, with a W8A8 DiT, K2; both take
bf16 or fp16, so an fp32 pipeline there needs ``attention_backend="plain"``. The staged path keeps the JAX package's
automatic rule (the kernel from 2048 tokens); the fused path, whose tiles
fall below that, takes the kernel at every length.

A Wan2.1 configuration (``config.family == "wan"``, models/wan_dit.py and
models/wan_vae.py) takes the staged path's entry, padding and stages with
its own bodies: ``enc`` the Wan VAE over whole frames, chunk by chunk with
its cache (``enc.chunks``), no spatial windows; ``dit`` the posterior mean
normalised by the latent statistics and one flow-matching step at
``sr_noise_step`` (``dit.cross_attn`` inside); ``dec`` one latent frame per
chunk (``dec.chunks``), clamped and quantised as each chunk comes. It
serves in the model dtype only (no ``quantize`` mode, no fused path, no
mesh).

Each call of ``process_frames`` is one unit of ``obs``: its spans (``prep``,
``enc`` with ``enc.upload``, ``enc.upscale``, ``enc.windows`` and
``enc.assemble``, ``dit`` with the int8 modes' ``dit.quantize`` and
``dit.dequantize``, ``dec`` with ``dec.windows``, ``dec.assemble`` and
``dec.download``, ``finish``; ``fused`` on the fused path) are timed on the
device's clock, or the host's for host work, and with the window counters
(``enc.windows_n``, ``enc.window_px``, ``enc.frame_px`` and the decoder's)
land in ``stage_times`` when the clip ends.

Mesh serving (``process_frames(mesh=...)``, ``parallel/``): one process per
device, every rank calling with the same clip. On the staged path the
spatial windows of the encode and decode spread over the ranks and
all-gather (bit for bit the single-device windows), the DiT runs
tensor-parallel over "model" (and sequence-parallel over "data" for a single
clip), and with more than one chunk the "data" rows take a chunk each; on
the fused path the tile batches split over "data". Each rank draws the noise
one process would draw and takes its share, so data-parallel output equals
world size 1. Rank 0 returns the clip, the other ranks None. Streaming is a
one-device path and stays off on a mesh.
"""

from __future__ import annotations

import dataclasses
import functools
import logging
import math
import time
from collections.abc import Iterator
from pathlib import Path
from typing import Any

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

from dove_tpu_torch import obs, tiling
from dove_tpu_torch.config import PipelineConfig
from dove_tpu_torch.io import video as video_io
from dove_tpu_torch.models import vae as vae_mod
from dove_tpu_torch.models.dit import CogVideoXTransformer3D, temporal_pad
from dove_tpu_torch.models.vae import AutoencoderKLCogVideoX
from dove_tpu_torch.models.wan_vae import latent_stats
from dove_tpu_torch.ops import quant
from dove_tpu_torch.ops.resize import resize
from dove_tpu_torch.ops.scheduler import Schedule, flow_x0
from dove_tpu_torch.parallel import distributed as dist_mod
from dove_tpu_torch.parallel.tp import Group, validate_tp
from dove_tpu_torch.train.losses import one_step_x0_latent

logger = logging.getLogger(__name__)

MAX_FRAMES_PER_PASS = 33
QUANTIZE_MODES = ("int8", "int8-dit", "int8-vae", "int8w", "int8-dit-dec")
# Streaming: the first pixel segment carries the causally special first
# frame; later segments are a multiple of the 4x temporal ratio.
STREAM_SEG0_PX = 33
STREAM_SEG_PX = 32


def plan_stream_segments(num_frames: int) -> list[tuple[int, int]]:
    """Contiguous (start, end) pixel-frame segments: [33] + [32]*k + tail.

    num_frames must satisfy the causal-VAE frame rule ((F-1) % 4 == 0), so
    every boundary after the first segment is a multiple of 4, which keeps
    the temporal pooling and upsampling aligned with whole-clip processing."""
    if (num_frames - 1) % 4:
        raise ValueError(f"streamed clips need (F - 1) % 4 == 0, got F={num_frames}")
    bounds = [(0, min(STREAM_SEG0_PX, num_frames))]
    start = STREAM_SEG0_PX
    while start < num_frames:
        bounds.append((start, min(start + STREAM_SEG_PX, num_frames)))
        start += STREAM_SEG_PX
    return bounds


def plan_dit_windows(
    n_lat: int, window: int, overlap: int
) -> list[tuple[int, int, int, int]]:
    """Overlapping DiT windows over the latent stream -> (ws, we, klo, khi).

    Each window spans stream latents [ws, we); its kept region is [klo, khi)
    in window-local coordinates. Interior boundaries sit at the midpoint of
    each overlap (the latent-space analog of the reference's overlap_t // 2
    pixel trim). The last window is right-aligned so all windows share one
    shape; every stream latent is written exactly once."""
    if n_lat <= window:
        return [(0, n_lat, 0, n_lat)]
    stride = max(window - overlap, 1)
    n = -(-(n_lat - window) // stride) + 1
    starts = [min(i * stride, n_lat - window) for i in range(n)]
    bounds = [0]
    for prev, s in zip(starts[:-1], starts[1:]):
        cover = prev + window - s  # actual overlap (>= overlap)
        bounds.append(s + (cover + 1) // 2)
    bounds.append(n_lat)
    return [
        (s, s + window, bounds[i] - s, bounds[i + 1] - s)
        for i, s in enumerate(starts)
    ]


def _grad_off(method):
    """``method`` under inference_mode, or under no_grad where the caller
    turned ``inference_mode`` off."""
    @functools.wraps(method)
    def run(self, *args, **kwargs):
        with torch.inference_mode() if self.inference_mode else torch.no_grad():
            return method(self, *args, **kwargs)

    return run


def _one_unit(method):
    """``method`` as one unit of ``obs``, its spans and counters left in
    ``self.stage_times`` when it returns."""
    @functools.wraps(method)
    def run(self, *args, **kwargs):
        with obs.unit(self.device) as unit:
            out = method(self, *args, **kwargs)
        self.stage_times = unit.times
        return out

    return run


def _groups(items: list, size: int) -> Iterator[list]:
    """Consecutive groups of at most ``size`` items."""
    size = max(1, size)
    for i in range(0, len(items), size):
        yield items[i:i + size]


def resolve_device(device: str | torch.device | None) -> torch.device:
    """``None`` means the card; asking for CUDA without one raises."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU"
        )
    return device


def _trim_output(out: np.ndarray, pad_f: int, pad_h: int, pad_w: int, upscale: int):
    """Strip the pad_video padding from a finished clip (RGB [F,H,W,3] or
    planar I420 [F,H*3/2,W])."""
    if pad_f:
        out = out[:-pad_f]
    if (pad_h or pad_w) and video_io.is_i420(out):
        Hp2 = out.shape[1] * 2 // 3
        return tiling.i420_crop(
            out, Hp2 - pad_h * upscale, out.shape[2] - pad_w * upscale
        )
    if pad_h:
        out = out[:, : -pad_h * upscale]
    if pad_w:
        out = out[:, :, : -pad_w * upscale]
    return out


def plan_axis(size: int, blend: int, max_tile: int) -> tuple[int, int, int]:
    """Uniform minimal-coverage tiling of one axis -> (tile, stride, n): the
    fewest tiles of size <= max_tile with a fixed ``blend`` feather band,
    sized so (n-1)*stride + tile barely covers ``size``."""
    if size <= max_tile:
        return size, size, 1
    n = -(-(size - blend) // (max_tile - blend))  # ceil division
    tile = min(-(-(size - blend) // n) + blend, max_tile)
    return tile, tile - blend, n


def count_windows(stage: str, n_rows: int, n_cols: int, tile_h: int, tile_w: int,
                  lat_h: int, lat_w: int) -> None:
    """Count a window plan of ``stage`` ("enc" or "dec") once: its windows,
    the latent positions (h x w) they compute and those of the frame."""
    obs.count(f"{stage}.windows_n", n_rows * n_cols)
    obs.count(f"{stage}.window_px", n_rows * n_cols * tile_h * tile_w)
    obs.count(f"{stage}.frame_px", lat_h * lat_w)


def feather_assemble(
    tiles: list[torch.Tensor],  # row-major, each [..., th, tw, C]
    n_rows: int, n_cols: int,
    blend_h: int, blend_w: int,
    out_h: int, out_w: int,
) -> torch.Tensor:
    """Feathered assembly of row-major tiles -> [..., H, W, C].

    Each tile's leading ``blend`` rows/cols are lerped with its upper/left
    neighbour's trailing band in fp32; interior tiles place ``stride``
    pixels, the last row/col keeps its full extent."""
    th, tw = tiles[0].shape[-3], tiles[0].shape[-2]
    h_ax, w_ax = tiles[0].ndim - 3, tiles[0].ndim - 2

    def lerp(a_band, b_band, extent, axis):
        shape = [1] * b_band.ndim
        shape[axis] = extent
        w = (torch.arange(extent, dtype=torch.float32, device=b_band.device)
             / extent).reshape(shape)
        return (a_band.float() * (1 - w) + b_band.float() * w).to(b_band.dtype)

    result_rows = []
    prev_row: list[torch.Tensor] | None = None
    for r in range(n_rows):
        row = tiles[r * n_cols:(r + 1) * n_cols]
        out_row = []
        for c, tile in enumerate(row):
            if prev_row is not None and blend_h > 0:
                band = lerp(prev_row[c].narrow(h_ax, th - blend_h, blend_h),
                            tile.narrow(h_ax, 0, blend_h), blend_h, h_ax)
                tile = torch.cat([band, tile.narrow(h_ax, blend_h, th - blend_h)],
                                 dim=h_ax)
            if c > 0 and blend_w > 0:
                band = lerp(row[c - 1].narrow(w_ax, tw - blend_w, blend_w),
                            tile.narrow(w_ax, 0, blend_w), blend_w, w_ax)
                tile = torch.cat([band, tile.narrow(w_ax, blend_w, tw - blend_w)],
                                 dim=w_ax)
            h_keep = th if r == n_rows - 1 else th - blend_h
            w_keep = tw if c == n_cols - 1 else tw - blend_w
            out_row.append(tile.narrow(h_ax, 0, h_keep).narrow(w_ax, 0, w_keep))
        result_rows.append(torch.cat(out_row, dim=w_ax))
        prev_row = row
    out = torch.cat(result_rows, dim=h_ax)
    return out.narrow(h_ax, 0, out_h).narrow(w_ax, 0, out_w)


def _edge_pad_hw(x: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """Edge-replicate [B, F, H, W, C] up to (h, w) at the bottom/right."""
    H, W = x.shape[2], x.shape[3]
    if h > H:
        x = x.index_select(2, torch.arange(h, device=x.device).clamp_(max=H - 1))
    if w > W:
        x = x.index_select(3, torch.arange(w, device=x.device).clamp_(max=W - 1))
    return x


def bilinear_upscale(x: torch.Tensor, factor: int) -> torch.Tensor:
    """[B, F, H, W, C] -> [B, F, H*u, W*u, C], half-pixel bilinear with edge
    clamping (what ``jax.image.resize(..., "bilinear")`` does when
    upsampling)."""
    B, Fr, H, W, C = x.shape
    y = x.permute(0, 1, 4, 2, 3).reshape(B * Fr, C, H, W)
    y = F.interpolate(y, size=(H * factor, W * factor), mode="bilinear",
                      align_corners=False)
    return y.reshape(B, Fr, C, H * factor, W * factor).permute(0, 1, 3, 4, 2)


@dataclasses.dataclass
class DovePipeline:
    """One-step 4x VSR: the staged path (``vae_tiling=True``) or the fused
    outer-tile path."""

    config: PipelineConfig
    dit: CogVideoXTransformer3D  # or models.wan_dit.WanModel (a Wan2.1 config)
    vae: AutoencoderKLCogVideoX  # or models.wan_vae.WanVAE_
    prompt_embedding: torch.Tensor  # [L_text, text_embed_dim] (empty prompt)
    dtype: torch.dtype = torch.bfloat16
    device: Any = None  # None = "cuda" (raises without a card); "cpu" on request
    attention_backend: str | None = None
    sample_posterior: bool = True  # the reference samples latent_dist
    # --is_vae_st: the staged path (internal VAE windows, no outer tiles);
    # False serves the fused outer-tile path, as the JAX package's default
    vae_tiling: bool = False
    output_uint8: bool = False
    # planar BT.601 studio-swing I420 [F, H*3//2, W] instead of RGB
    output_i420: bool = False
    # int8 serving modes (ops/quant.py), quantized in place when the pipeline
    # is built (the DiT and VAE passed in become the int8 ones):
    #   "int8":     DiT and VAE quantized;
    #   "int8-dit": W8A8 DiT linears (int8 weights, per-token int8
    #               activations) and, on the card, K2's int8 Q K^T attention;
    #               the VAE stays in the model dtype;
    #   "int8-vae": the VAE's hot convs int8 (K4 on the card), the DiT not;
    #   "int8w":    W8A16 DiT, int8 weights dequantized into the bf16 matmuls;
    #   "int8-dit-dec": int8 DiT and int8 VAE decoder, the encoder float (its
    #               error would feed the DiT; the decoder's stays in pixels).
    # Each takes the JAX package's window plan for its mode.
    quantize: str | None = None
    # {name: per-input-channel activation amax, name + "#tapcorr": ...} from
    # models.vae.calibrate: where the mode quantizes the VAE, each matched
    # conv is equalized (and GPTQ-rounded with a tapcorr). Ignored otherwise.
    vae_calib: dict | None = None
    # runtime conv names (ops.quant.calib_name) kept in the model dtype inside
    # a quantized VAE; "lowres" stands for lowres_decoder_exclusions(vae)
    vae_exclude: tuple[str, ...] = ()
    # K4's plain version instead of the kernel on any device ("plain"), for
    # comparisons; None is the kernel on the card
    conv_backend: str | None = None
    # route the eligible float 3x3x3 VAE convs through K5, the hand-written
    # bf16 conv, instead of cuDNN (models.vae.set_pallas_conv; process-wide)
    hand_conv: bool = False
    # Streamed long-clip path ("auto" | "on" | "off" | bool): clips of more
    # than one pass run as contiguous segments with the causal conv caches
    # carried across them, and only the DiT runs on overlapping latent
    # windows. "auto" streams in the int8-DiT modes, as the JAX package
    # does on a directly attached device; bf16 keeps the overlap-chunk path.
    streaming: str | bool = "auto"
    # DiT windows of the streamed path in latent frames: 10 with an overlap
    # of 2 is a 33-frame pass with an 8-frame overlap.
    dit_window_latents: int = 10
    dit_overlap_latents: int = 2
    # latent frames per decoder call in the streamed decode
    stream_decode_latents: int = 2
    # spatial windows run together (as one batch) through the streamed
    # encode and decode; their caches live across all segments
    stream_enc_group: int = 4
    stream_dec_group: int = 2
    # longer clips take the overlap-chunk path (window outputs of the whole
    # clip stay on the device until assembly)
    stream_max_frames: int = 320
    # optional (h, w) cap on the decode window, in latents
    dec_window_cap: tuple[int, int] | None = None
    # a LoRA tree (train/lora.py) merged into each layer's attention
    # projections inside the DiT's forward: a trainer's validation serves
    # its live DiT and adapters without a merged copy of the weights
    lora: Any = None
    lora_scale: float = 1.0
    # serve under torch.inference_mode; a trainer validating its live DiT
    # turns it off (no_grad instead: FSDP2's gathers bump version counters,
    # which inference tensors lack)
    inference_mode: bool = True

    def __post_init__(self):
        self.device = resolve_device(self.device)
        if self.dec_window_cap is not None and min(self.dec_window_cap) <= 2:
            raise ValueError(
                "dec_window_cap must exceed the 2-latent feather band "
                f"(each side >= 3); got {self.dec_window_cap}"
            )
        if self.quantize is not None and self.quantize not in QUANTIZE_MODES:
            raise ValueError(f"unknown quantize mode: {self.quantize}")
        if self.conv_backend not in (None, "plain"):
            raise ValueError(f"unknown conv_backend: {self.conv_backend}")
        if self.output_i420 and not (self.vae_tiling and self.output_uint8):
            raise ValueError(
                "output_i420 requires the staged path (vae_tiling=True) "
                "with output_uint8=True"
            )
        self.vae_exclude = tuple(self.vae_exclude)
        self._stream_enabled()  # an unknown streaming value fails here
        self._wan = self.config.family == "wan"
        if self._wan and (self.quantize is not None or self.config.noise_step != 0):
            raise ValueError("a Wan2.1 pipeline serves in its model dtype at noise_step 0: "
                             "no quantize mode")
        T = self.config.scheduler.num_train_timesteps
        for name in ("sr_noise_step", "noise_step"):
            t = getattr(self.config, name)
            if not 0 <= t < T:
                raise ValueError(f"{name}={t} outside [0, {T})")
        self.schedule = Schedule.create(self.config.scheduler)
        self.dit = self.dit.to(device=self.device, dtype=self.dtype).eval()
        if self._dit_resident_int8:
            self.dit = quant.quantize_dit(self.dit, w_only=self.quantize == "int8w")
        if (self._dit_quantized and self.attention_backend is None
                and self.device.type == "cuda"):
            # W8A8 serving: Q K^T in int8 too (K2), as the JAX package does
            # on its accelerator; the CPU keeps the automatic dispatch
            self.attention_backend = "flash-qk8"
        self.vae = self.vae.to(device=self.device, dtype=self.dtype).eval()
        if self._vae_decoder_quantized:
            if "lowres" in self.vae_exclude:
                # expand the named set against this VAE before the names
                # are validated
                self.vae_exclude = tuple(
                    n for n in self.vae_exclude if n != "lowres"
                ) + quant.lowres_decoder_exclusions(self.vae)
            self.vae = quant.quantize_vae(
                self.vae, which="all" if self._vae_quantized else "decoder",
                calib=self.vae_calib, exclude=self.vae_exclude)
        for mod in self.vae.modules():
            if isinstance(mod, quant.QConv3d):
                mod.backend = self.conv_backend
        vae_mod.set_pallas_conv(self.hand_conv)
        self.prompt_embedding = self.prompt_embedding.to(self.device, self.dtype)
        # the last clip's spans (seconds) and counters, set by process_frames
        self.stage_times: dict[str, float] = {}
        # mesh serving: the ranks that share the spatial windows and the
        # DiT's sequence-parallel group, set per call by process_frames
        self._win: Group | None = None
        self._dit_sp: Group | None = None

    @property
    def _dit_quantized(self) -> bool:
        """W8A8 compute: int8 activations and K2's int8 Q K^T."""
        return self.quantize in ("int8", "int8-dit", "int8-dit-dec")

    @property
    def _dit_resident_int8(self) -> bool:
        """DiT weights stored int8, the W8A16 mode included."""
        return self.quantize in ("int8", "int8-dit", "int8w", "int8-dit-dec")

    @property
    def _vae_quantized(self) -> bool:
        return self.quantize in ("int8", "int8-vae")

    @property
    def _vae_decoder_quantized(self) -> bool:
        return self.quantize in ("int8", "int8-vae", "int8-dit-dec")

    def _window_budget(self) -> tuple[int, tuple[int, int], tuple[int, int]]:
        """(blend_lat, (enc_max_h, enc_max_w), (dec_max_h, dec_max_w)) in
        latents: the JAX package's plans for a 16 GB device, by mode. An
        int8 DiT leaves room for larger windows than bf16; an int8 decoder
        beside it for the largest decode windows, and an int8 encoder too
        for the largest encode windows."""
        if self._dit_quantized and self._vae_quantized:
            blend, enc_max, dec_max = 2, (46, 42), (46, 42)
        elif self.quantize == "int8-dit-dec":
            blend, enc_max, dec_max = 2, (40, 38), (46, 42)
        elif self._dit_resident_int8:
            blend, enc_max, dec_max = 2, (40, 38), (36, 34)
        else:
            blend, enc_max, dec_max = 2, (32, 32), (28, 28)
        if self.dec_window_cap is not None:
            dec_max = (min(dec_max[0], self.dec_window_cap[0]),
                       min(dec_max[1], self.dec_window_cap[1]))
        return blend, enc_max, dec_max

    def _stream_enabled(self, mesh=None) -> bool:
        if mesh is not None and mesh.size > 1:
            return False  # a one-device path: meshes spread chunks instead
        mode = self.streaming
        if isinstance(mode, str):
            if mode == "auto":
                return self._dit_resident_int8
            if mode.lower() in ("1", "true", "on", "yes"):
                return True
            if mode.lower() in ("0", "false", "off", "no"):
                return False
            raise ValueError(f"streaming={mode!r}: expected auto/on/off")
        return bool(mode)

    # ------------------------------------------------------------------
    # The three stages
    # ------------------------------------------------------------------

    def _window_map(self, fn, coords: list) -> list[torch.Tensor]:
        """``[fn(c) for c in coords]``, spread over the window ranks: the
        work-list pads to a multiple of their count with repeats of its last
        entry, each rank runs its contiguous block (the JAX package's
        ``shard_map`` of ``lax.map``) and the outputs all-gather. Each window
        is the same computation either way, so the result is bit for bit the
        single-device one."""
        g = self._win
        if g is None or len(coords) == 1:
            return [fn(c) for c in coords]
        n = len(coords)
        per = -(-n // g.size)
        padded = list(coords) + [coords[-1]] * (per * g.size - n)
        mine = torch.stack([fn(c) for c in padded[g.rank * per:(g.rank + 1) * per]])
        parts = [torch.empty_like(mine) for _ in range(g.size)]
        dist.all_gather(parts, mine.contiguous(), group=g.group)
        return list(torch.cat(parts)[:n].unbind(0))

    def enc_all(self, lq: torch.Tensor) -> torch.Tensor:
        """lq: [1, F, H, W, 3] in [-1, 1] at LQ resolution -> assembled
        moments [1, F', H*u/8, W*u/8, 2C]."""
        cfg = self.config
        s = cfg.vae.spatial_scale
        _, _, H, W, _ = lq.shape
        Hu, Wu = H * cfg.upscale, W * cfg.upscale
        lat_h, lat_w = Hu // s, Wu // s
        blend, enc_max, _ = self._window_budget()
        tile_h, stride_h, n_rows = plan_axis(lat_h, blend, enc_max[0])
        tile_w, stride_w, n_cols = plan_axis(lat_w, blend, enc_max[1])
        count_windows("enc", n_rows, n_cols, tile_h, tile_w, lat_h, lat_w)
        with obs.span("enc.upscale"):
            up = _edge_pad_hw(bilinear_upscale(lq.float(), cfg.upscale).to(lq.dtype),
                              ((n_rows - 1) * stride_h + tile_h) * s,
                              ((n_cols - 1) * stride_w + tile_w) * s)
        if n_rows == 1 and n_cols == 1:
            with obs.span("enc.windows"):
                return vae_mod.encode_moments(cfg.vae, self.vae, up)
        th, tw = tile_h * s, tile_w * s
        with obs.span("enc.windows"):
            tiles = self._window_map(
                lambda rc: vae_mod.encode_moments(
                    cfg.vae, self.vae,
                    up[:, :, rc[0] * stride_h * s:rc[0] * stride_h * s + th,
                       rc[1] * stride_w * s:rc[1] * stride_w * s + tw]),
                [(r, c) for r in range(n_rows) for c in range(n_cols)])
        with obs.span("enc.assemble"):
            return feather_assemble(
                tiles, n_rows, n_cols,
                blend if n_rows > 1 else 0, blend if n_cols > 1 else 0,
                lat_h, lat_w,
            )

    def dit_step(
        self, moments: torch.Tensor, generator: torch.Generator | None = None
    ) -> torch.Tensor:
        """moments [B, F', h, w, 2C] -> unscaled x-hat_0 latent [B, F', h, w, C]."""
        latent = vae_mod.sample_latent(
            moments, generator if self.sample_posterior else None,
            self.config.vae.scaling_factor,
        )
        return self._denoise(latent, generator)

    def _draw_noise(self, shape: tuple, generator: torch.Generator,
                    part: tuple[int, int] | None = None) -> torch.Tensor:
        """The noise added at ``noise_step``: fp32 normals in the DiT layout
        (``part``: this share of the whole batch's draw)."""
        return vae_mod.draw_part(shape, generator, self.device, part)

    def _skip_draws(self, lat_shape: tuple, generator: torch.Generator) -> None:
        """Advance ``generator`` past the draws of one DiT step over a
        latent of ``lat_shape`` [B, F', h, w, C], as ``dit_step`` makes
        them: a data-parallel rank passes over the chunks of the others."""
        B, Fl, h, w, C = lat_shape
        if self.sample_posterior:
            vae_mod.draw_part(lat_shape, generator, self.device)
        if self.config.noise_step != 0:
            self._draw_noise((B, Fl + temporal_pad(self.config.dit, Fl), C, h, w),
                             generator)

    def _denoise(
        self, latent: torch.Tensor, generator: torch.Generator | None,
        attention_backend: str | None = None, part: tuple[int, int] | None = None,
    ) -> torch.Tensor:
        """Scaled latent [B, F', h, w, C] -> unscaled x-hat_0, one DiT pass
        (``attention_backend`` None: the pipeline's; ``part``: a share of a
        data-parallel batch)."""
        cfg = self.config
        B, Fl, h, w, C = latent.shape
        text = self.prompt_embedding[None].expand(B, -1, -1)
        noise = None
        if cfg.noise_step != 0 and generator is not None:
            shape = (B, Fl + temporal_pad(cfg.dit, Fl), C, h, w)
            # the two-argument call is the hook tests override
            noise = (self._draw_noise(shape, generator) if part is None
                     else self._draw_noise(shape, generator, part))
        x0 = one_step_x0_latent(
            cfg, self.schedule, self.dit, latent, text, noise,
            attention_backend=attention_backend or self.attention_backend,
            bounded_logits=True,  # frozen qk-layernorm gains at inference
            lora=self.lora, lora_scale=self.lora_scale, sp=self._dit_sp,
        )
        return x0 / torch.tensor(cfg.vae.scaling_factor, dtype=x0.dtype)

    def sr_tile(self, tile: torch.Tensor, generator: torch.Generator,
                part: tuple[int, int] | None = None) -> torch.Tensor:
        """The fused path's one device call: tile [B, F, H, W, 3] in [-1, 1]
        (model dtype, F a causal-VAE length) -> [B, F, H, W, 3] fp32 in
        [0, 1]. Encode (frame-chunked, causal cache), sample, one DiT pass
        over the B tiles at ``sr_noise_step`` (noise added at ``noise_step``
        first when it is nonzero), decode.

        On the card the attention is the kernel at every length, as in the
        trainer: the automatic rule's 2048-token threshold would send the
        tiles' shorter passes to the naive path. An explicit
        ``attention_backend`` wins. ``part`` (i, n): ``tile`` is share i of a
        batch cut n ways over the data ranks, whose noise is drawn whole."""
        cfg = self.config
        moments = vae_mod.encode_moments(cfg.vae, self.vae, tile)
        latent = vae_mod.sample_latent(
            moments, generator if self.sample_posterior else None,
            cfg.vae.scaling_factor, part)
        backend = self.attention_backend
        if backend is None and self.device.type == "cuda":
            backend = "flash"
        x0 = self._denoise(latent, generator, backend, part)
        pixels = vae_mod.decode(cfg.vae, self.vae, x0)
        return (pixels.float() * 0.5 + 0.5).clamp(0.0, 1.0)

    def dec_float(self, z: torch.Tensor) -> torch.Tensor:
        """z: [B, F', h, w, C] unscaled latent -> [B, F, H, W, 3] fp32 in
        [0, 1], decoded over feathered windows."""
        cfg = self.config
        s = cfg.vae.spatial_scale
        _, _, zh, zw, _ = z.shape
        blend, _, dec_max = self._window_budget()
        tile_h, stride_h, n_rows = plan_axis(zh, blend, dec_max[0])
        tile_w, stride_w, n_cols = plan_axis(zw, blend, dec_max[1])
        count_windows("dec", n_rows, n_cols, tile_h, tile_w, zh, zw)
        if n_rows == 1 and n_cols == 1:
            with obs.span("dec.windows"):
                pixels = vae_mod.decode(cfg.vae, self.vae, z)
        else:
            with obs.span("dec.windows"):
                zp = _edge_pad_hw(z, (n_rows - 1) * stride_h + tile_h,
                                  (n_cols - 1) * stride_w + tile_w)
                tiles = self._window_map(
                    lambda rc: vae_mod.decode(
                        cfg.vae, self.vae,
                        zp[:, :, rc[0] * stride_h:rc[0] * stride_h + tile_h,
                           rc[1] * stride_w:rc[1] * stride_w + tile_w]),
                    [(r, c) for r in range(n_rows) for c in range(n_cols)])
            with obs.span("dec.assemble"):
                pixels = feather_assemble(
                    tiles, n_rows, n_cols,
                    (blend if n_rows > 1 else 0) * s,
                    (blend if n_cols > 1 else 0) * s,
                    zh * s, zw * s,
                )
        with obs.span("dec.assemble"):
            return (pixels.float() * 0.5 + 0.5).clamp(0.0, 1.0)

    def quantize_frames(self, out01: torch.Tensor) -> torch.Tensor:
        """[B, F, H, W, 3] float in [0,1] -> uint8 RGB, or packed I420.
        torch.round rounds halves to even, as jnp.round does."""
        Bp, Fp, Hp, Wp = out01.shape[:4]
        if self.output_i420 and Hp % 2 == 0 and Wp % 2 == 0:
            # BT.601 studio swing (Y 16-235, chroma 16-240), cv2's I420
            r, g, b = out01[..., 0], out01[..., 1], out01[..., 2]
            ey = 0.299 * r + 0.587 * g + 0.114 * b
            y = 16.0 + 219.0 * ey
            u = 128.0 + (112.0 / 0.886) * (b - ey)
            v = 128.0 + (112.0 / 0.701) * (r - ey)
            u2 = u.reshape(Bp, Fp, Hp // 2, 2, Wp // 2, 2).mean(dim=(3, 5))
            v2 = v.reshape(Bp, Fp, Hp // 2, 2, Wp // 2, 2).mean(dim=(3, 5))

            def q(x: torch.Tensor) -> torch.Tensor:
                return torch.round(x.clamp(0.0, 255.0)).to(torch.uint8)

            flat = torch.cat(
                [q(y).reshape(Bp, Fp, -1), q(u2).reshape(Bp, Fp, -1),
                 q(v2).reshape(Bp, Fp, -1)], dim=2,
            )
            return flat.reshape(Bp, Fp, Hp * 3 // 2, Wp)
        return torch.round(out01 * 255.0).to(torch.uint8)

    def dec_all(self, z: torch.Tensor) -> torch.Tensor:
        """Window decode + assembly + uint8 (or I420) quantization."""
        out01 = self.dec_float(z)
        with obs.span("dec.assemble"):
            return self.quantize_frames(out01)

    # ------------------------------------------------------------------
    # Host-side driver
    # ------------------------------------------------------------------

    def _barrier(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _sr_clip_wan(self, clip: np.ndarray) -> np.ndarray:
        """The Wan2.1 stages of one pass (``_sr_clip_staged``'s contract)."""
        cfg = self.config
        with obs.span("enc"):
            with obs.span("enc.upload"):
                lq = torch.as_tensor(clip[None]).to(self.device).to(self.dtype)
            with obs.span("enc.upscale"):
                up = bilinear_upscale(lq.float(), cfg.upscale).to(self.dtype)
                up = up.permute(0, 4, 1, 2, 3)  # [1, 3, F, H, W]
            with obs.span("enc.chunks"):
                mu = self.vae.encode(up)
            del up
        with obs.span("dit"):
            mean, std = latent_stats(cfg.vae, self.device)
            z = (mu.float() - mean) / std
            t = torch.full((1,), cfg.sr_noise_step, dtype=torch.long, device=self.device)
            u = self.dit(z, self.prompt_embedding[None], t,
                         attention_backend=self.attention_backend)
            # sigma = t / T: the flow schedule at shift 1
            x0 = flow_x0(z, u, cfg.sr_noise_step / cfg.scheduler.num_train_timesteps)
            del z, u
        with obs.span("dec"):
            with obs.span("dec.chunks"):
                frames = [self.quantize_frames(
                    (px.float().clamp(-1.0, 1.0) * 0.5 + 0.5).permute(0, 2, 3, 4, 1))
                    for px in self.vae.decode_chunks((x0 * std + mean).to(self.dtype))]
            with obs.span("dec.assemble"):
                out = torch.cat(frames, dim=1)[0]
            with obs.span("dec.download"):
                return out.cpu().numpy()

    @_grad_off
    def _sr_clip_staged(self, clip: np.ndarray, generator: torch.Generator) -> np.ndarray:
        """One pass: clip [F, H, W, 3] float in [-1, 1] at LQ resolution ->
        uint8 [F, H*u, W*u, 3] (or I420). The stages run back to back on one
        stream: the caching allocator hands out memory in the host's order,
        so a stage's temporaries never overlap the next one's whether or not
        the host waits between them; it waits only for the copy to the
        host."""
        if self._wan:
            return self._sr_clip_wan(clip)
        with obs.span("enc"):
            with obs.span("enc.upload"):
                lq = torch.as_tensor(clip[None]).to(self.device).to(self.dtype)
            moments = self.enc_all(lq)
        with obs.span("dit"):
            z = self.dit_step(moments, generator)
        with obs.span("dec"):
            frames = self.dec_all(z)[0]
            with obs.span("dec.download"):
                return frames.cpu().numpy()

    @_grad_off
    def _sr_clip_streamed(
        self, clip: np.ndarray, generator: torch.Generator,
        overlap_lat: int | None = None,
    ) -> np.ndarray:
        """Streamed SR of a whole clip: clip [F, H, W, 3] float in [-1, 1] at
        LQ resolution with (F-1) % 4 == 0 -> uint8 [F, H*u, W*u, 3] (or I420).

        Three phases, each window-major: a group of spatial windows runs
        through every temporal segment, its causal conv caches carried from
        one segment to the next, before the next group starts, so only one
        group's caches are alive at a time.

          enc: moment windows -> per segment, feather and sample -> latents
          dit: overlapping latent windows, trimmed at the overlap midpoints
          dec: pixel windows -> per segment, feather and quantize -> host
        """
        cfg = self.config
        s = cfg.vae.spatial_scale
        F_, Hl, Wl, _ = clip.shape
        Hp, Wp = Hl * cfg.upscale, Wl * cfg.upscale
        lat_h, lat_w = Hp // s, Wp // s
        n_lat = cfg.vae.latent_frames(F_)
        blend, enc_max, dec_max = self._window_budget()
        segs = plan_stream_segments(F_)
        lat0 = cfg.vae.latent_frames(segs[0][1])

        def lat_span(i: int) -> tuple[int, int]:
            s0, e0 = segs[i]
            if i == 0:
                return 0, lat0
            ls = lat0 + (s0 - segs[0][1]) // cfg.vae.temporal_compression_ratio
            return ls, ls + (e0 - s0) // cfg.vae.temporal_compression_ratio

        # ---- enc: window-major groups, the cache handed across segments ----
        with obs.span("enc"):
            e_th, e_sh, e_nr = plan_axis(lat_h, blend, enc_max[0])
            e_tw, e_sw, e_nc = plan_axis(lat_w, blend, enc_max[1])
            count_windows("enc", e_nr, e_nc, e_th, e_tw, lat_h, lat_w)
            cover = ((e_nr - 1) * e_sh + e_th) * s, ((e_nc - 1) * e_sw + e_tw) * s
            coords = [(r * e_sh * s, c * e_sw * s)
                      for r in range(e_nr) for c in range(e_nc)]
            with obs.span("enc.upload"):
                lq = torch.as_tensor(clip).to(self.device).to(self.dtype)[None]
            moments: list[list[torch.Tensor]] = [[] for _ in segs]
            for group in _groups(coords, self.stream_enc_group):
                cache = None
                for si, (s0, e0) in enumerate(segs):
                    with obs.span("enc.upscale"):
                        up = _edge_pad_hw(
                            bilinear_upscale(lq[:, s0:e0].float(), cfg.upscale)
                            .to(self.dtype), *cover)
                    with obs.span("enc.windows"):
                        tiles = torch.cat([
                            up[:, :, y:y + e_th * s, x:x + e_tw * s] for y, x in group])
                        m, cache = vae_mod.encode_moments_cached(
                            cfg.vae, self.vae, tiles, cache)
                    moments[si].extend(m.unbind(0))
                del cache
            with obs.span("enc.assemble"):
                lat_stream = torch.empty(
                    (1, n_lat, lat_h, lat_w, cfg.vae.latent_channels),
                    dtype=self.dtype, device=self.device)
                for si in range(len(segs)):
                    m = feather_assemble(
                        [t[None] for t in moments[si]], e_nr, e_nc,
                        blend if e_nr > 1 else 0, blend if e_nc > 1 else 0,
                        lat_h, lat_w)
                    moments[si] = []
                    ls, le = lat_span(si)
                    lat_stream[:, ls:le] = vae_mod.sample_latent(
                        m, generator if self.sample_posterior else None,
                        cfg.vae.scaling_factor)

        # ---- dit: overlapping windows, midpoint trim in latent space ----
        with obs.span("dit"):
            wplan = plan_dit_windows(
                n_lat, self.dit_window_latents,
                self.dit_overlap_latents if overlap_lat is None else overlap_lat)
            x0_stream = torch.empty_like(lat_stream)
            for ws, we, klo, khi in wplan:
                x0 = self._denoise(lat_stream[:, ws:we], generator)
                x0_stream[:, ws + klo:ws + khi] = x0[:, klo:khi]
            del lat_stream

        # ---- dec: window-major groups, no temporal seams ----
        with obs.span("dec"):
            d_th, d_sh, d_nr = plan_axis(lat_h, blend, dec_max[0])
            d_tw, d_sw, d_nc = plan_axis(lat_w, blend, dec_max[1])
            count_windows("dec", d_nr, d_nc, d_th, d_tw, lat_h, lat_w)
            with obs.span("dec.windows"):
                zp = _edge_pad_hw(x0_stream, (d_nr - 1) * d_sh + d_th,
                                  (d_nc - 1) * d_sw + d_tw)
                del x0_stream
                coords = [(r * d_sh, c * d_sw) for r in range(d_nr) for c in range(d_nc)]
                pixels: list[list[torch.Tensor]] = [[] for _ in segs]
                for group in _groups(coords, self.stream_dec_group):
                    cache = None
                    for si in range(len(segs)):
                        ls, le = lat_span(si)
                        tiles = torch.cat([
                            zp[:, ls:le, y:y + d_th, x:x + d_tw] for y, x in group])
                        px, cache = vae_mod.decode_cached(
                            cfg.vae, self.vae, tiles, cache, self.stream_decode_latents)
                        pixels[si].extend(px.unbind(0))
                    del cache
                del zp
            out = np.empty((F_, Hp * 3 // 2, Wp) if self.output_i420
                           else (F_, Hp, Wp, 3), np.uint8)
            for si, (s0, e0) in enumerate(segs):
                with obs.span("dec.assemble"):
                    seg = feather_assemble(
                        [t[None] for t in pixels[si]], d_nr, d_nc,
                        (blend if d_nr > 1 else 0) * s, (blend if d_nc > 1 else 0) * s,
                        Hp, Wp)
                    pixels[si] = []
                    frames = self.quantize_frames((seg.float() * 0.5 + 0.5).clamp(0.0, 1.0))
                with obs.span("dec.download"):
                    out[s0:e0] = frames[0].cpu().numpy()
        return out

    def _upscale_input(self, padded: np.ndarray, upscale: int,
                       upscale_mode: str) -> torch.Tensor:
        """The fused path's input: padded [F, H, W, 3] in [0, 1] -> [F, H*u,
        W*u, 3] fp32 in [-1, 1] on the device, every mode through
        ``ops/resize.py``: the counterpart of the cv2 resize the JAX package
        calls (bilinear: also of ``native.upscale_bilinear``)."""
        if upscale_mode not in video_io.UPSCALE_MODES:
            raise ValueError(f"unknown upscale mode {upscale_mode!r}; one of "
                             f"{sorted(video_io.UPSCALE_MODES)}")
        x = torch.as_tensor(padded, dtype=torch.float32).to(self.device)
        if upscale != 1:
            x = resize(x, (x.shape[1] * upscale, x.shape[2] * upscale),
                       video_io.UPSCALE_MODES[upscale_mode])
        return x * 2.0 - 1.0

    @_grad_off
    def _sr_fused(
        self, padded: np.ndarray, upscale: int, chunk_len: int,
        tile_size_hw: tuple[int, int], overlap_t: int,
        overlap_hw: tuple[int, int], seed: int, tile_batch: int,
        upscale_mode: str, dp: Group | None = None,
    ) -> torch.Tensor | None:
        """The fused outer-tile path over a padded clip -> stitched [3, F,
        H*u, W*u] fp32 on the device. Same-shaped tiles run in batches of
        ``tile_batch`` (the last one padded with repeats of its last tile,
        their outputs dropped); each batch takes the generator's next draws.
        Nothing is pulled to the host: the stitch runs on the device. ``dp``:
        the "data" ranks split each batch (``tile_batch`` rounded up to a
        multiple of their count) and all-gather it; rank 0 of the group
        stitches and the others return None."""
        if dp is not None:
            tile_batch = -(-max(tile_batch, dp.size) // dp.size) * dp.size
        up = self._upscale_input(padded, upscale, upscale_mode)
        F_, H, W, _ = up.shape
        tiles = tiling.plan_tiles(F_, H, W, chunk_len, tile_size_hw, overlap_t,
                                  overlap_hw)
        effective_ot = overlap_t if chunk_len > 0 else 0
        geoms = tiling.tile_geometries(tiles)
        logger.info(
            "clip: %d frames %dx%d -> %d tiles (batch %d), %d geometries %s",
            F_, H, W, len(tiles), tile_batch, len(geoms), sorted(geoms),
        )
        stitcher = tiling.TorchStitcher(3, F_, H, W, effective_ot, overlap_hw,
                                        device=self.device)
        generator = torch.Generator(device=self.device).manual_seed(seed)

        def tile_data(t: tiling.Tile) -> tuple[torch.Tensor, int]:
            data = up[t.t_start:t.t_end, t.h_start:t.h_end, t.w_start:t.w_end]
            # causal-VAE frame rule: pad an odd-length chunk (a merged tail)
            # up to the next length the roundtrip keeps, trim after
            nf = data.shape[0]
            valid_nf = tiling.next_valid_frames(nf)
            if valid_nf != nf:
                data = torch.cat([data, data[-1:].expand(valid_nf - nf, -1, -1, -1)])
            return data, nf

        by_geom: dict[tuple, list[tiling.Tile]] = {}
        for t in tiles:
            by_geom.setdefault(t.shape, []).append(t)
        for group in by_geom.values():
            for batch_tiles in _groups(group, tile_batch):
                datas, nfs = zip(*(tile_data(t) for t in batch_tiles))
                n_real = len(datas)
                if n_real < tile_batch:
                    datas = datas + (datas[-1],) * (tile_batch - n_real)
                batch = torch.stack(datas).to(self.dtype)
                if dp is None:
                    out = self.sr_tile(batch, generator)
                else:
                    k = tile_batch // dp.size
                    mine = self.sr_tile(batch[dp.rank * k:(dp.rank + 1) * k], generator,
                                        (dp.rank, dp.size))
                    parts = [torch.empty_like(mine) for _ in range(dp.size)]
                    dist.all_gather(parts, mine.contiguous(), group=dp.group)
                    if dp.rank:
                        continue
                    out = torch.cat(parts)
                for t, nf, o in zip(batch_tiles, nfs, out[:n_real]):
                    stitcher.add(t, o[:nf].permute(3, 0, 1, 2))
                del out
        return None if dp is not None and dp.rank else stitcher.finalize()

    def _mesh_route(self, mesh, staged: bool) -> None:
        """Set the mesh state of one clip: the window ranks, and sequence
        parallelism over "data" (a single clip: B = 1 cannot split over the
        data ranks). A "model" axis needs the staged path and a DiT that the
        caller split over it (``parallel.tp.shard_dit_tp``)."""
        self._win = self._dit_sp = None
        tp = 1 if mesh is None else mesh.shape["model"]
        if tp > 1:
            if not staged:
                # the fused path shards tile batches over "data" only: a
                # silent idle model axis would misreport scaling
                raise ValueError("a mesh 'model' axis (tensor parallelism) requires "
                                 "the staged path: vae_tiling=True without outer tiles")
            validate_tp(self.config.dit, tp)
        split = getattr(self.dit, "tp", None)
        if (1 if split is None else split.size) != tp:
            raise ValueError(
                f"the DiT is split {1 if split is None else split.size} ways and the "
                f"mesh's 'model' axis has {tp} ranks: split it once with "
                "parallel.tp.shard_dit_tp(dit, mesh.axis_group('model')) and pass "
                "that mesh on every call")
        if mesh is None or mesh.size == 1:
            return
        if staged:
            self._win = mesh.axis_group(None)
            self._dit_sp = mesh.axis_group("data")

    @_one_unit
    def process_frames(
        self,
        frames: np.ndarray,  # [F, H, W, 3] float32 in [0, 1] (LQ input)
        *,
        upscale: int | None = None,
        chunk_len: int = 0,
        tile_size_hw: tuple[int, int] = (0, 0),
        # None: 8 frames for the chunked paths, the pipeline's
        # dit_overlap_latents for streaming; an explicit value (0 included)
        # is honoured by every path
        overlap_t: int | None = None,
        overlap_hw: tuple[int, int] = (32, 32),
        seed: int = 42,
        tile_batch: int = 1,
        mesh=None,
        upscale_mode: str = "bilinear",
    ) -> np.ndarray | None:
        """Full one-step SR of a clip -> [F, H*u, W*u, 3] float32 in [0, 1];
        on the staged path uint8 (RGB, or I420 [F, H*u*3//2, W*u]) with
        output_uint8. The staged path runs when ``vae_tiling`` is set and
        ``tile_size_hw`` is (0, 0), the fused outer-tile path otherwise
        (``overlap_hw``, ``tile_batch`` and ``upscale_mode`` apply to it).
        ``mesh`` (``parallel.mesh.make_mesh``): every rank calls with the
        same clip, rank 0 gets it back and the others None; with a "model"
        axis the DiT must be split over it first (``_mesh_route``)."""
        upscale = self.config.upscale if upscale is None else upscale
        staged = self.vae_tiling and tuple(tile_size_hw) == (0, 0)
        if self._wan and (not staged or mesh is not None):
            raise ValueError("a Wan2.1 pipeline runs the staged path (vae_tiling=True, no "
                             "outer tiles) on one device")
        self._mesh_route(mesh, staged)
        lead = mesh is None or mesh.rank == 0
        if not staged:
            with obs.span("fused"):
                padded, (pad_f, pad_h, pad_w) = tiling.pad_video(frames)
                dp = None if mesh is None else mesh.axis_group("data")
                out = self._sr_fused(
                    padded, upscale, chunk_len, tuple(tile_size_hw),
                    8 if overlap_t is None else overlap_t, tuple(overlap_hw), seed,
                    max(1, tile_batch), upscale_mode, dp)
                if out is None:
                    return None
                out = tiling.unpad_video(out, pad_f, pad_h * upscale, pad_w * upscale)
                # [3, F, H, W] -> [F, H, W, 3], then one pull to the host
                result = out.permute(1, 2, 3, 0).contiguous().cpu().numpy()
            return result if lead else None
        if upscale != self.config.upscale:
            raise ValueError(
                "the staged path upscales on the device using config.upscale; "
                "rebuild the pipeline config to change it"
            )
        with obs.span("prep", host=True):
            padded, (pad_f, pad_h, pad_w) = tiling.pad_video(frames)
            lq = padded * 2.0 - 1.0  # [-1, 1] at LQ resolution
        F_ = lq.shape[0]
        generator = torch.Generator(device=self.device).manual_seed(seed)

        if (chunk_len == 0 and MAX_FRAMES_PER_PASS < F_ <= self.stream_max_frames
                and self._stream_enabled(mesh)):
            # an explicit overlap_t (pixel frames) becomes latent frames
            out = self._sr_clip_streamed(
                lq, generator,
                overlap_lat=None if overlap_t is None else max(0, round(overlap_t / 4)),
            )
            with obs.span("finish", host=True):
                out = _trim_output(out, pad_f, pad_h, pad_w, upscale)
                return out if self.output_uint8 else out.astype(np.float32) / 255.0

        if overlap_t is None:
            overlap_t = 8  # the reference's default
        if chunk_len == 0 and F_ > MAX_FRAMES_PER_PASS:
            chunk_len = MAX_FRAMES_PER_PASS
            logger.warning(
                "staged path: temporal chunking %d frames into %d-frame passes",
                F_, chunk_len,
            )
        effective_ot = overlap_t if chunk_len > 0 else 0
        if chunk_len and chunk_len <= effective_ot:
            raise ValueError("chunk_len must be greater than overlap_t")
        extra_f = 0
        if chunk_len and F_ > chunk_len:
            # tail-pad so every chunk has the same length (uniform stride)
            stride = chunk_len - effective_ot
            f_ext = chunk_len + math.ceil((F_ - chunk_len) / stride) * stride
            extra_f = f_ext - F_
            if extra_f:
                with obs.span("prep", host=True):
                    lq = np.concatenate([lq, np.repeat(lq[-1:], extra_f, axis=0)])
            F_ = f_ext
        chunks = tiling.temporal_chunks(F_, chunk_len, effective_ot)

        def chunk_data(ts: int, te: int) -> tuple[np.ndarray, int]:
            data = lq[ts:te]
            nf = data.shape[0]
            valid_nf = tiling.next_valid_frames(nf)
            if valid_nf != nf:
                with obs.span("prep", host=True):
                    data = np.concatenate(
                        [data, np.repeat(data[-1:], valid_nf - nf, axis=0)])
            return data, nf

        if mesh is not None and mesh.shape["data"] > 1 and len(chunks) > 1:
            # chunk-parallel: each "data" row takes one chunk of every group
            # of n_par (its windows and TP over its "model" ranks) and passes
            # over the others' draws, so each chunk sees the noise it gets at
            # world size 1; rank 0 collects the pieces
            n_par, d = mesh.shape["data"], mesh.coord("data")
            self._dit_sp = None
            self._win = mesh.axis_group("model")
            s, u = self.config.vae.spatial_scale, self.config.upscale
            mine = []
            for g0 in range(0, len(chunks), n_par):
                for j, (ts, te) in enumerate(chunks[g0:g0 + n_par]):
                    data, nf = chunk_data(ts, te)
                    if j == d:
                        mine.append(((ts, te), self._sr_clip_staged(data, generator)[:nf]))
                    else:
                        self._skip_draws(
                            (1, self.config.vae.latent_frames(data.shape[0]),
                             data.shape[1] * u // s, data.shape[2] * u // s,
                             self.config.vae.latent_channels), generator)
            pieces = dist_mod.gather_objects(mine if mesh.coord("model") == 0 else [])
            if pieces is None:
                return None
            produced = dict(p for rank_pieces in pieces for p in rank_pieces)
        else:
            produced = {}
            for ts, te in chunks:
                data, nf = chunk_data(ts, te)
                produced[(ts, te)] = self._sr_clip_staged(data, generator)[:nf]
            if not lead:
                return None

        # trim-based temporal stitching: every frame is written once (a
        # single chunk keeps all of its frames)
        with obs.span("finish", host=True):
            out = None
            for ts, te in chunks:
                piece = produced[(ts, te)]
                if out is None:
                    out = np.empty((F_,) + piece.shape[1:], np.uint8)
                vr = tiling.valid_region(
                    tiling.Tile(ts, te, 0, 1, 0, 1), (F_, 1, 1), effective_ot, (0, 0)
                )
                out[vr.dst[0]] = piece[vr.src[0]]
            if extra_f:
                out = out[:-extra_f]
            out = _trim_output(out, pad_f, pad_h, pad_w, upscale)
            return out if self.output_uint8 else out.astype(np.float32) / 255.0

    def process_video_file(self, path: str | Path, **kwargs) -> np.ndarray | None:
        frames = video_io.read_video_frames(path)
        t0 = time.perf_counter()
        out = self.process_frames(frames, **kwargs)
        logger.info("processed %s in %.2fs", path, time.perf_counter() - t0)
        return out
