"""DOVE one-step video super-resolution, the staged path, in PyTorch.

Counterpart of ``dove_tpu/pipeline.py``'s staged branch (``vae_tiling=True``,
the reference's ``--is_vae_st`` default) for bf16 or fp32 with no
quantization. A clip of up to 33 frames is one pass of three stages, each
ended by a device synchronisation (the stage barrier):

  * enc: 4x bilinear upscale on the device, VAE encode over feathered
    spatial windows, feathered assembly of the moments;
  * dit: the posterior mean (or a sample), one DiT pass at t=399, and
    x-hat_0 = sqrt(abar) z - sqrt(1-abar) v-hat (train/losses.py);
  * dec: VAE decode over windows, feathered assembly, uint8 RGB or BT.601
    I420.

Longer clips run as overlapping 33-frame chunks, trimmed at the overlap
midpoints (the reference's temporal stitching). The window plan is the JAX
package's bf16 plan, so seams fall where they fall there. On the card the
DiT's attention takes K1, which is bf16 only: an fp32 pipeline there needs
``attention_backend="plain"``.

Not ported yet (each raises): the fused outer-tile path (vae_tiling=False or
tile_size_hw), the streaming segmented path, mesh serving and the int8
modes.
"""

from __future__ import annotations

import dataclasses
import logging
import math
import time
from pathlib import Path
from typing import Any

import numpy as np
import torch
import torch.nn.functional as F
from torch.profiler import record_function

from dove_tpu_torch import tiling
from dove_tpu_torch.config import PipelineConfig
from dove_tpu_torch.io import video as video_io
from dove_tpu_torch.models import vae as vae_mod
from dove_tpu_torch.models.dit import CogVideoXTransformer3D
from dove_tpu_torch.models.vae import AutoencoderKLCogVideoX
from dove_tpu_torch.ops.scheduler import Schedule
from dove_tpu_torch.train.losses import one_step_x0_latent

logger = logging.getLogger(__name__)

MAX_FRAMES_PER_PASS = 33
# bf16 window budget of the JAX plan: 2-latent feather band, max window
# (h, w) in latents for encode and for decode
BLEND_LAT = 2
ENC_MAX = (32, 32)
DEC_MAX = (28, 28)


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
    """One-step 4x VSR, staged path (``vae_tiling=True``)."""

    config: PipelineConfig
    dit: CogVideoXTransformer3D
    vae: AutoencoderKLCogVideoX
    prompt_embedding: torch.Tensor  # [L_text, text_embed_dim] (empty prompt)
    dtype: torch.dtype = torch.bfloat16
    device: Any = None  # None = "cuda" (raises without a card); "cpu" on request
    attention_backend: str | None = None
    sample_posterior: bool = True  # the reference samples latent_dist
    vae_tiling: bool = True  # --is_vae_st: the staged path (False raises)
    output_uint8: bool = False
    # planar BT.601 studio-swing I420 [F, H*3//2, W] instead of RGB
    output_i420: bool = False
    quantize: str | None = None  # int8 modes: not ported yet

    def __post_init__(self):
        self.device = resolve_device(self.device)
        if self.quantize is not None:
            raise NotImplementedError(
                f"quantize={self.quantize!r}: the int8 modes are not ported yet"
            )
        if self.output_i420 and not (self.vae_tiling and self.output_uint8):
            raise ValueError(
                "output_i420 requires the staged path (vae_tiling=True) "
                "with output_uint8=True"
            )
        T = self.config.scheduler.num_train_timesteps
        for name in ("sr_noise_step", "noise_step"):
            t = getattr(self.config, name)
            if not 0 <= t < T:
                raise ValueError(f"{name}={t} outside [0, {T})")
        self.schedule = Schedule.create(self.config.scheduler)
        self.dit = self.dit.to(device=self.device, dtype=self.dtype).eval()
        self.vae = self.vae.to(device=self.device, dtype=self.dtype).eval()
        self.prompt_embedding = self.prompt_embedding.to(self.device, self.dtype)
        # per-clip stage wall times (seconds), reset by process_frames
        self.stage_times: dict[str, float] = {}

    # ------------------------------------------------------------------
    # The three stages
    # ------------------------------------------------------------------

    def enc_all(self, lq: torch.Tensor) -> torch.Tensor:
        """lq: [1, F, H, W, 3] in [-1, 1] at LQ resolution -> assembled
        moments [1, F', H*u/8, W*u/8, 2C]."""
        cfg = self.config
        s = cfg.vae.spatial_scale
        _, _, H, W, _ = lq.shape
        Hu, Wu = H * cfg.upscale, W * cfg.upscale
        up = bilinear_upscale(lq.float(), cfg.upscale).to(lq.dtype)
        lat_h, lat_w = Hu // s, Wu // s
        tile_h, stride_h, n_rows = plan_axis(lat_h, BLEND_LAT, ENC_MAX[0])
        tile_w, stride_w, n_cols = plan_axis(lat_w, BLEND_LAT, ENC_MAX[1])
        if n_rows == 1 and n_cols == 1:
            return vae_mod.encode_moments(cfg.vae, self.vae, up)
        th, tw = tile_h * s, tile_w * s
        up = _edge_pad_hw(up, ((n_rows - 1) * stride_h + tile_h) * s,
                          ((n_cols - 1) * stride_w + tile_w) * s)
        tiles = [
            vae_mod.encode_moments(
                cfg.vae, self.vae,
                up[:, :, r * stride_h * s:r * stride_h * s + th,
                   c * stride_w * s:c * stride_w * s + tw],
            )
            for r in range(n_rows) for c in range(n_cols)
        ]
        return feather_assemble(
            tiles, n_rows, n_cols,
            BLEND_LAT if n_rows > 1 else 0, BLEND_LAT if n_cols > 1 else 0,
            lat_h, lat_w,
        )

    def dit_step(
        self, moments: torch.Tensor, generator: torch.Generator | None = None
    ) -> torch.Tensor:
        """moments [B, F', h, w, 2C] -> unscaled x-hat_0 latent [B, F', h, w, C]."""
        cfg = self.config
        latent = vae_mod.sample_latent(
            moments, generator if self.sample_posterior else None,
            cfg.vae.scaling_factor,
        )
        B, Fl, h, w, C = latent.shape
        text = self.prompt_embedding[None].expand(B, -1, -1)
        noise = None
        if cfg.noise_step != 0 and generator is not None:
            pt = cfg.dit.patch_size_t
            noise = torch.randn(
                (B, Fl + (pt - Fl % pt) % pt, C, h, w), generator=generator,
                device=latent.device, dtype=torch.float32,
            )
        x0 = one_step_x0_latent(
            cfg, self.schedule, self.dit, latent, text, noise,
            attention_backend=self.attention_backend,
            bounded_logits=True,  # frozen qk-layernorm gains at inference
        )
        return x0 / torch.tensor(cfg.vae.scaling_factor, dtype=x0.dtype)

    def dec_float(self, z: torch.Tensor) -> torch.Tensor:
        """z: [B, F', h, w, C] unscaled latent -> [B, F, H, W, 3] fp32 in
        [0, 1], decoded over feathered windows."""
        cfg = self.config
        s = cfg.vae.spatial_scale
        _, _, zh, zw, _ = z.shape
        tile_h, stride_h, n_rows = plan_axis(zh, BLEND_LAT, DEC_MAX[0])
        tile_w, stride_w, n_cols = plan_axis(zw, BLEND_LAT, DEC_MAX[1])
        if n_rows == 1 and n_cols == 1:
            pixels = vae_mod.decode(cfg.vae, self.vae, z)
        else:
            zp = _edge_pad_hw(z, (n_rows - 1) * stride_h + tile_h,
                              (n_cols - 1) * stride_w + tile_w)
            tiles = [
                vae_mod.decode(
                    cfg.vae, self.vae,
                    zp[:, :, r * stride_h:r * stride_h + tile_h,
                       c * stride_w:c * stride_w + tile_w],
                )
                for r in range(n_rows) for c in range(n_cols)
            ]
            pixels = feather_assemble(
                tiles, n_rows, n_cols,
                (BLEND_LAT if n_rows > 1 else 0) * s,
                (BLEND_LAT if n_cols > 1 else 0) * s,
                zh * s, zw * s,
            )
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
        return self.quantize_frames(self.dec_float(z))

    # ------------------------------------------------------------------
    # Host-side driver
    # ------------------------------------------------------------------

    def _barrier(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _add_time(self, stage: str, seconds: float) -> None:
        self.stage_times[stage] = self.stage_times.get(stage, 0.0) + seconds

    @torch.inference_mode()
    def _sr_clip_staged(self, clip: np.ndarray, generator: torch.Generator) -> np.ndarray:
        """One pass: clip [F, H, W, 3] float in [-1, 1] at LQ resolution ->
        uint8 [F, H*u, W*u, 3] (or I420). The stage barriers keep one
        stage's temporaries from overlapping the next one's. Each stage is
        a named range ("dove.enc", ...) in a torch.profiler trace."""
        t0 = time.perf_counter()
        with record_function("dove.enc"):
            lq = torch.as_tensor(clip[None]).to(self.device).to(self.dtype)
            moments = self.enc_all(lq)
            self._barrier()
        t1 = time.perf_counter()
        self._add_time("enc", t1 - t0)
        with record_function("dove.dit"):
            z = self.dit_step(moments, generator)
            self._barrier()
        t2 = time.perf_counter()
        self._add_time("dit", t2 - t1)
        with record_function("dove.dec"):
            out = self.dec_all(z)[0].cpu().numpy()
        self._add_time("dec", time.perf_counter() - t2)
        return out

    def process_frames(
        self,
        frames: np.ndarray,  # [F, H, W, 3] float32 in [0, 1] (LQ input)
        *,
        upscale: int | None = None,
        chunk_len: int = 0,
        tile_size_hw: tuple[int, int] = (0, 0),
        overlap_t: int | None = None,
        seed: int = 42,
        mesh=None,
    ) -> np.ndarray:
        """Full one-step SR of a clip -> [F, H*u, W*u, 3] float32 in [0, 1],
        or uint8 (RGB, or I420 [F, H*u*3//2, W*u]) with output_uint8."""
        if not self.vae_tiling or tuple(tile_size_hw) != (0, 0):
            raise NotImplementedError(
                "only the staged path (vae_tiling=True, no outer tiles) is "
                "ported; the fused outer-tile path is not"
            )
        if mesh is not None:
            raise NotImplementedError("mesh serving is not ported yet")
        upscale = self.config.upscale if upscale is None else upscale
        if upscale != self.config.upscale:
            raise ValueError(
                "the staged path upscales on the device using config.upscale; "
                "rebuild the pipeline config to change it"
            )
        self.stage_times = {}
        padded, (pad_f, pad_h, pad_w) = tiling.pad_video(frames)
        lq = padded * 2.0 - 1.0  # [-1, 1] at LQ resolution
        F_ = lq.shape[0]

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
                lq = np.concatenate([lq, np.repeat(lq[-1:], extra_f, axis=0)])
            F_ = f_ext
        chunks = tiling.temporal_chunks(F_, chunk_len, effective_ot)
        generator = torch.Generator(device=self.device).manual_seed(seed)

        def chunk_out(ts: int, te: int) -> np.ndarray:
            data = lq[ts:te]
            nf = data.shape[0]
            valid_nf = tiling.next_valid_frames(nf)
            if valid_nf != nf:
                data = np.concatenate(
                    [data, np.repeat(data[-1:], valid_nf - nf, axis=0)])
            return self._sr_clip_staged(data, generator)[:nf]

        # trim-based temporal stitching: every frame is written once (a
        # single chunk keeps all of its frames)
        out = None
        for ts, te in chunks:
            piece = chunk_out(ts, te)
            if out is None:
                out = np.empty((F_,) + piece.shape[1:], np.uint8)
            vr = tiling.valid_region(
                tiling.Tile(ts, te, 0, 1, 0, 1), (F_, 1, 1), effective_ot, (0, 0)
            )
            out[vr.dst[0]] = piece[vr.src[0]]
        if extra_f:
            out = out[:-extra_f]
        out = _trim_output(out, pad_f, pad_h, pad_w, upscale)
        if self.output_uint8:
            return out
        return out.astype(np.float32) / 255.0

    def process_video_file(self, path: str | Path, **kwargs) -> np.ndarray:
        frames = video_io.read_video_frames(path)
        t0 = time.perf_counter()
        out = self.process_frames(frames, **kwargs)
        logger.info("processed %s in %.2fs", path, time.perf_counter() - t0)
        return out
