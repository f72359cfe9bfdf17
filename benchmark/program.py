"""What the benchmark builds of the program: its configuration from a
configuration file, and its DiT and VAE holding the benchmark's seeded weights."""

from __future__ import annotations

import torch

from benchmark import weights


def pipeline_config(config: dict):
    """The program's PipelineConfig from a configuration file."""
    from dove_tpu_torch.config import DiTConfig, PipelineConfig, SchedulerConfig, VAEConfig

    vae = dict(config["vae"], block_out_channels=tuple(config["vae"]["block_out_channels"]))
    return PipelineConfig(dit=DiTConfig(**config["dit"]), vae=VAEConfig(**vae),
                          scheduler=SchedulerConfig(**config["scheduler"]),
                          sr_noise_step=config["sr_noise_step"],
                          noise_step=config["noise_step"], upscale=config["upscale"])


def build_models(cfg, seed: int, dtype, device):
    """The program's DiT and VAE holding the benchmark's seeded weights."""
    from dove_tpu_torch.models.dit import CogVideoXTransformer3D
    from dove_tpu_torch.models.vae import AutoencoderKLCogVideoX

    models = []
    for cls, c, stream in ((CogVideoXTransformer3D, cfg.dit, weights.DIT),
                           (AutoencoderKLCogVideoX, cfg.vae, weights.VAE)):
        with torch.device("meta"):
            m = cls(c, dtype=dtype)
        spec = [(k, tuple(v.shape)) for k, v in m.state_dict().items()]
        m.load_state_dict(weights.make(spec, seed, stream, dtype, device), assign=True)
        models.append(m.eval().requires_grad_(False))
    return models
