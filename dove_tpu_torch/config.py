"""Model / scheduler / pipeline configuration for the PyTorch port.

A copy of ``dove_tpu/config.py`` (the port imports nothing of the JAX
package): the same dataclasses, presets and diffusers-config loaders, so a
configuration means the same model on both sides. Field semantics mirror the
diffusers checkpoint configs (``transformer/config.json``,
``vae/config.json``, ``scheduler/scheduler_config.json``).
"""

from __future__ import annotations

import dataclasses
import json
import math
from pathlib import Path
from typing import Any


@dataclasses.dataclass(frozen=True)
class DiTConfig:
    """CogVideoX Transformer3D ("DiT") architecture config."""

    num_layers: int = 42
    num_attention_heads: int = 48
    attention_head_dim: int = 64
    in_channels: int = 16
    out_channels: int = 16
    patch_size: int = 2
    patch_size_t: int | None = 2  # None => CogVideoX-1.0 style (no temporal patching)
    patch_bias: bool = False
    text_embed_dim: int = 4096
    max_text_seq_length: int = 226
    time_embed_dim: int = 512
    timestep_activation_fn: str = "silu"
    activation_fn: str = "gelu-approximate"
    ff_mult: int = 4
    attention_bias: bool = True
    norm_eps: float = 1e-5
    norm_elementwise_affine: bool = True
    qk_norm_eps: float = 1e-6
    flip_sin_to_cos: bool = True
    freq_shift: int = 0
    use_rotary_positional_embeddings: bool = True
    use_learned_positional_embeddings: bool = False
    rope_theta: float = 10000.0
    sample_height: int = 300
    sample_width: int = 300
    sample_frames: int = 81
    temporal_compression_ratio: int = 4
    spatial_interpolation_scale: float = 1.875
    temporal_interpolation_scale: float = 1.0

    @property
    def hidden_dim(self) -> int:
        return self.num_attention_heads * self.attention_head_dim

    @property
    def ff_dim(self) -> int:
        return self.hidden_dim * self.ff_mult


@dataclasses.dataclass(frozen=True)
class VAEConfig:
    """CogVideoX 3D causal VAE (AutoencoderKLCogVideoX) architecture config."""

    in_channels: int = 3
    out_channels: int = 3
    latent_channels: int = 16
    block_out_channels: tuple[int, ...] = (128, 256, 256, 512)
    layers_per_block: int = 3
    norm_num_groups: int = 32
    norm_eps: float = 1e-6
    temporal_compression_ratio: int = 4
    scaling_factor: float = 0.7
    # Carried for diffusers-config compatibility but INTENTIONALLY not
    # consumed: the DOVE reference multiplies encoded latents by
    # scaling_factor unconditionally (inference_script.py:409,
    # lora_one_s1_trainer.py:69) even though the 1.5 VAE config sets this
    # flag — we match the reference's behavior, not diffusers'.
    invert_scale_latents: bool = False
    # Frame-slicing batch sizes used by chunked encode/decode (diffusers'
    # num_sample_frames_batch_size / num_latent_frames_batch_size are 8 / 2).
    # Larger defaults: on TPU the activation temp barely grows with the
    # frame-chunk size (buffers are reused across frames), while each extra
    # chunk body multiplies the program's op count — and per-op overhead, not
    # FLOPs, dominates the chunked VAE. Memory-constrained callers pass
    # chunk_frames explicitly.
    sample_frames_batch_size: int = 64
    latent_frames_batch_size: int = 16
    # Internal spatial tiling geometry (feathered blending), pixel space.
    tile_sample_min_height: int = 256
    tile_sample_min_width: int = 256
    tile_overlap_factor_height: float = 1 / 6
    tile_overlap_factor_width: float = 1 / 5
    # Decoder-side latent tile override (None = tile_sample_min / 8). The
    # decoder's upsampled activations are ~16x the encoder's per pixel, so a
    # smaller decode tile keeps peak HBM bounded next to resident DiT weights.
    decode_tile_latent_height: int | None = None
    decode_tile_latent_width: int | None = None

    @property
    def spatial_scale(self) -> int:
        """Spatial downscale factor: 2**(num_blocks-1) == 8."""
        return 2 ** (len(self.block_out_channels) - 1)

    @staticmethod
    def tile_geometry(lat_tile: int, factor: float) -> tuple[int, int]:
        """(blend, stride) for the feathered tiler, both in LATENT units.

        Deriving the sampling stride from the placement size (stride =
        lat_tile - blend) keeps sampled and assembled tile positions exactly
        aligned. diffusers computes them independently
        (``int(tile*(1-factor))`` vs ``tile - int(tile*factor)``), which
        drifts content by the rounding gap per tile row — we fix that rather
        than reproduce it (documented deviation, see PARITY.md)."""
        blend = int(lat_tile * factor)
        return blend, max(lat_tile - blend, 1)

    @property
    def temporal_compress_level(self) -> int:
        return int(math.log2(self.temporal_compression_ratio))

    def latent_frames(self, frames: int) -> int:
        """Pixel frame count F (with (F-1)%ratio==0) -> latent frame count."""
        return (frames - 1) // self.temporal_compression_ratio + 1


@dataclasses.dataclass(frozen=True)
class SchedulerConfig:
    """v-prediction diffusion schedule (CogVideoXDPMScheduler subset).

    Only the alpha-bar schedule algebra is needed by DOVE: ``add_noise`` and the
    ``get_velocity``-as-x0 trick (the reference's inference_script.py:457,491).
    """

    num_train_timesteps: int = 1000
    beta_start: float = 0.00085
    beta_end: float = 0.012
    beta_schedule: str = "scaled_linear"
    snr_shift_scale: float = 1.0
    rescale_betas_zero_snr: bool = True
    prediction_type: str = "v_prediction"
    timestep_spacing: str = "trailing"


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    """Bundle of all model configs plus DOVE one-step inference constants."""

    dit: DiTConfig = dataclasses.field(default_factory=DiTConfig)
    vae: VAEConfig = dataclasses.field(default_factory=VAEConfig)
    scheduler: SchedulerConfig = dataclasses.field(default_factory=SchedulerConfig)
    sr_noise_step: int = 399
    noise_step: int = 0
    upscale: int = 4


# ---------------------------------------------------------------------------
# Presets
# ---------------------------------------------------------------------------

def cogvideox1_5_5b() -> PipelineConfig:
    """DOVE's backbone: CogVideoX1.5-5B (patch_size_t=2, RoPE, 42 layers)."""
    return PipelineConfig(
        dit=DiTConfig(),
        vae=VAEConfig(
            scaling_factor=0.7,
            invert_scale_latents=True,
            # These fields drive the diffusers-parity tiled_* API
            # (models/vae.py). The staged serving path self-plans its tiling
            # (DovePipeline._plan_axis: minimal-coverage uniform grids with a
            # fixed 2-latent feather band, HBM-budgeted max tile sizes).
            # 24-latent (192 px) decode tiles: decoder peak HBM must coexist
            # with ~10.4 GB of resident DiT weights on a 16 GB chip.
            decode_tile_latent_height=24,
            decode_tile_latent_width=24,
            # Leaner feather overlap than diffusers' (1/6, 1/5); the 16-21 px
            # blend bands still hide seams. Checkpoint-loaded configs
            # (config.json) keep the diffusers values for behavioral parity.
            tile_overlap_factor_height=1 / 12,
            tile_overlap_factor_width=1 / 12,
        ),
        scheduler=SchedulerConfig(snr_shift_scale=1.0),
    )


def cogvideox_2b() -> PipelineConfig:
    """DOVE-2B variant: CogVideoX-2B (30 layers, learned pos-emb, no RoPE)."""
    return PipelineConfig(
        dit=DiTConfig(
            num_layers=30,
            num_attention_heads=30,
            attention_head_dim=64,
            patch_size_t=None,
            patch_bias=True,
            use_rotary_positional_embeddings=False,
            use_learned_positional_embeddings=False,
            sample_height=60,
            sample_width=90,
            sample_frames=49,
        ),
        vae=VAEConfig(scaling_factor=1.15258426),
        scheduler=SchedulerConfig(snr_shift_scale=3.0),
    )


def tiny_test() -> PipelineConfig:
    """Tiny CPU-testable config preserving every structural quirk of the 1.5-5B."""
    return PipelineConfig(
        dit=DiTConfig(
            num_layers=2,
            num_attention_heads=4,
            attention_head_dim=16,
            in_channels=8,
            out_channels=8,
            text_embed_dim=32,
            max_text_seq_length=7,
            time_embed_dim=16,
        ),
        vae=VAEConfig(
            latent_channels=8,
            block_out_channels=(8, 16, 16, 32),
            layers_per_block=1,
            norm_num_groups=4,
            sample_frames_batch_size=8,
            latent_frames_batch_size=2,
            tile_sample_min_height=32,
            tile_sample_min_width=32,
        ),
    )


# ---------------------------------------------------------------------------
# diffusers-config loading (so released checkpoints drive the same code)
# ---------------------------------------------------------------------------

def _filter_kwargs(cls: type, raw: dict[str, Any]) -> dict[str, Any]:
    names = {f.name for f in dataclasses.fields(cls)}
    return {k: v for k, v in raw.items() if k in names}


def dit_config_from_json(path: str | Path) -> DiTConfig:
    raw = json.loads(Path(path).read_text())
    kwargs = _filter_kwargs(DiTConfig, raw)
    if "norm_eps" in raw:
        kwargs["norm_eps"] = raw["norm_eps"]
    return DiTConfig(**kwargs)


def vae_config_from_json(path: str | Path) -> VAEConfig:
    raw = json.loads(Path(path).read_text())
    kwargs = _filter_kwargs(VAEConfig, raw)
    if "block_out_channels" in raw:
        kwargs["block_out_channels"] = tuple(raw["block_out_channels"])
    return VAEConfig(**kwargs)


def scheduler_config_from_json(path: str | Path) -> SchedulerConfig:
    raw = json.loads(Path(path).read_text())
    return SchedulerConfig(**_filter_kwargs(SchedulerConfig, raw))


def pipeline_config_from_pretrained(model_dir: str | Path) -> PipelineConfig:
    """Build a PipelineConfig from a diffusers-layout checkpoint directory."""
    model_dir = Path(model_dir)
    return PipelineConfig(
        dit=dit_config_from_json(model_dir / "transformer" / "config.json"),
        vae=vae_config_from_json(model_dir / "vae" / "config.json"),
        scheduler=scheduler_config_from_json(
            model_dir / "scheduler" / "scheduler_config.json"
        ),
    )
