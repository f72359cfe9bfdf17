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

    dit: DiTConfig | WanDiTConfig = dataclasses.field(default_factory=DiTConfig)
    vae: VAEConfig | WanVAEConfig = dataclasses.field(default_factory=VAEConfig)
    scheduler: SchedulerConfig = dataclasses.field(default_factory=SchedulerConfig)
    sr_noise_step: int = 399
    noise_step: int = 0
    upscale: int = 4

    @property
    def family(self) -> str:
        """"wan" for a Wan2.1 DiT and VAE, else "cogvideox"."""
        return "wan" if isinstance(self.dit, WanDiTConfig) else "cogvideox"


@dataclasses.dataclass(frozen=True)
class WanDiTConfig:
    """Wan2.1 text-to-video DiT (``wan/modules/model.py`` ``WanModel``):
    the fields of its ``config.json`` and of ``wan/configs/wan_t2v_14B.py``."""

    dim: int = 5120
    ffn_dim: int = 13824
    freq_dim: int = 256
    num_heads: int = 40
    num_layers: int = 40
    in_dim: int = 16
    out_dim: int = 16
    text_len: int = 512
    text_dim: int = 4096
    patch_size: tuple[int, int, int] = (1, 2, 2)
    eps: float = 1e-6
    qk_norm: bool = True
    cross_attn_norm: bool = True
    window_size: tuple[int, int] = (-1, -1)
    rope_theta: float = 10000.0

    @property
    def head_dim(self) -> int:
        return self.dim // self.num_heads

    # the names the pipeline reads of either DiT family
    @property
    def max_text_seq_length(self) -> int:
        return self.text_len

    @property
    def text_embed_dim(self) -> int:
        return self.text_dim


# the 16-channel latent statistics of the public ``WanVAE`` wrapper
# (``wan/modules/vae.py``): encode returns (mu - mean) / std
WAN_LATENTS_MEAN = (-0.7571, -0.7089, -0.9113, 0.1075, -0.1745, 0.9653, -0.1517, 1.5508,
                    0.4134, -0.0715, 0.5517, -0.3632, -0.1922, -0.9497, 0.2503, -0.2921)
WAN_LATENTS_STD = (2.8184, 1.4541, 2.3275, 2.6558, 1.2196, 1.7708, 2.6052, 2.0743,
                   3.2687, 2.1526, 2.8652, 1.5579, 1.6382, 1.1253, 2.8251, 1.9160)


@dataclasses.dataclass(frozen=True)
class WanVAEConfig:
    """Wan2.1 causal video VAE (``wan/modules/vae.py`` ``_video_vae``):
    RMS norms, zero-padded causal convolutions, a cache of the last
    ``CACHE_T`` = 2 frames per convolution across chunks of 1 + 4k frames."""

    base_dim: int = 96
    z_dim: int = 16
    dim_mult: tuple[int, ...] = (1, 2, 4, 4)
    num_res_blocks: int = 2
    attn_scales: tuple[float, ...] = ()
    temperal_downsample: tuple[bool, ...] = (False, True, True)
    latents_mean: tuple[float, ...] = WAN_LATENTS_MEAN
    latents_std: tuple[float, ...] = WAN_LATENTS_STD

    @property
    def spatial_scale(self) -> int:
        return 2 ** (len(self.dim_mult) - 1)

    @property
    def temporal_compression_ratio(self) -> int:
        return 2 ** sum(bool(t) for t in self.temperal_downsample)

    @property
    def latent_channels(self) -> int:
        return self.z_dim

    def latent_frames(self, frames: int) -> int:
        return (frames - 1) // self.temporal_compression_ratio + 1


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


def wan2_1_t2v_14b() -> PipelineConfig:
    """Wan2.1-T2V-14B (https://huggingface.co/Wan-AI/Wan2.1-T2V-14B) on
    DOVE's one-step path: one flow-matching step at t = 399 (sigma 0.399,
    shift 1), x-hat_0 = z - sigma * u."""
    return PipelineConfig(dit=WanDiTConfig(), vae=WanVAEConfig())


def tiny_wan() -> PipelineConfig:
    """Tiny CPU-testable Wan: dim 256, 2 heads of 128, 2 layers, 16 text
    slots, VAE base 8; every structural quirk of the 14B kept."""
    return PipelineConfig(
        dit=WanDiTConfig(dim=256, ffn_dim=512, freq_dim=32, num_heads=2, num_layers=2,
                         text_len=16, text_dim=64),
        vae=WanVAEConfig(base_dim=8),
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


WAN_VAE_FILE = "Wan2.1_VAE.pth"


def is_wan_folder(model_dir: str | Path) -> bool:
    """A Wan2.1 release folder: a root ``config.json`` whose ``_class_name``
    is ``WanModel``."""
    path = Path(model_dir) / "config.json"
    if not path.is_file():
        return False
    return json.loads(path.read_text()).get("_class_name") == "WanModel"


def wan_dit_config_from_json(path: str | Path) -> WanDiTConfig:
    raw = json.loads(Path(path).read_text())
    kwargs = _filter_kwargs(WanDiTConfig, raw)
    for name in ("patch_size", "window_size"):
        if name in kwargs:
            kwargs[name] = tuple(kwargs[name])
    return WanDiTConfig(**kwargs)


def wan_vae_config_from_weights(path: str | Path) -> WanVAEConfig:
    """The release's ``_video_vae``, its base width and latent channels read
    from the shapes in ``Wan2.1_VAE.pth`` where the file is there (memory-
    mapped: nothing else is read)."""
    path = Path(path)
    if not path.is_file():
        return WanVAEConfig()
    import torch

    state = torch.load(path, map_location="cpu", weights_only=True, mmap=True)
    return WanVAEConfig(base_dim=state["encoder.conv1.weight"].shape[0],
                        z_dim=state["conv2.weight"].shape[0])


def pipeline_config_from_pretrained(model_dir: str | Path) -> PipelineConfig:
    """Build a PipelineConfig from a diffusers-layout checkpoint directory,
    or from a Wan2.1 release folder (root ``config.json`` of ``WanModel``,
    safetensors shards, ``Wan2.1_VAE.pth``), whose VAE is the fixed
    ``_video_vae`` of the release."""
    model_dir = Path(model_dir)
    if is_wan_folder(model_dir):
        return PipelineConfig(dit=wan_dit_config_from_json(model_dir / "config.json"),
                              vae=wan_vae_config_from_weights(model_dir / WAN_VAE_FILE))
    return PipelineConfig(
        dit=dit_config_from_json(model_dir / "transformer" / "config.json"),
        vae=vae_config_from_json(model_dir / "vae" / "config.json"),
        scheduler=scheduler_config_from_json(
            model_dir / "scheduler" / "scheduler_config.json"
        ),
    )
