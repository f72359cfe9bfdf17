"""Offline restoration of LQ clips through Wan2.1 on ``DovePipeline.process_frames``.

``serve_clip``'s closed loop, clips, unit and check, for a Wan2.1
configuration: set-up makes the Wan DiT and VAE on the device from the seed
(``benchmark/weights.py``'s rule, by the release's parameter names) and the
prompt embedding (row 0 drawn, the other ``text_len - 1`` rows zero, as
``WanModel`` pads an empty prompt's one umT5 token), builds the staged
pipeline and warms one clip. The check frees the program and runs
``reference/wan.py`` on one clip of the window drawn from the seed.

Controls (``readings.py`` and the tests only): the reference in the
program's place with float8 e4m3 DiT linears (``fp8``) or VAE convolutions
(``fp8-vae``). Faults: the DiT step handing back its input latent
(``state_unchanged``), one frame altered where it is made
(``answer_altered``).
"""

from __future__ import annotations

import gc
import math
import time

import numpy as np
import torch

from benchmark import weights
from benchmark.drivers import serve_clip
from benchmark.drivers.serve_clip import clip, gaps
from benchmark.reference import wan as ref
from benchmark.reference.models import fp8_conv3d, fp8_linear, strict_fp32

RATE = "frames_per_s"
LOWERED = {"fp8": dict(linear=fp8_linear), "fp8-vae": dict(conv3d=fp8_conv3d)}


def pipeline_config(config: dict):
    """The program's PipelineConfig of a Wan configuration file."""
    from dove_tpu_torch.config import (PipelineConfig, SchedulerConfig, WanDiTConfig,
                                       WanVAEConfig)

    d, v = config["dit"], config["vae"]
    dit = WanDiTConfig(**dict(d, patch_size=tuple(d["patch_size"]),
                              window_size=tuple(d["window_size"])))
    vae = WanVAEConfig(**{k: tuple(x) if isinstance(x, list) else x for k, x in v.items()})
    return PipelineConfig(
        dit=dit, vae=vae,
        scheduler=SchedulerConfig(num_train_timesteps=config["scheduler"]["num_train_timesteps"]),
        sr_noise_step=config["sr_noise_step"], noise_step=config["noise_step"],
        upscale=config["upscale"])


def build_models(cfg, seed: int, dtype, device):
    """The program's Wan DiT and VAE holding the benchmark's seeded weights."""
    from dove_tpu_torch.models.wan_dit import WanModel
    from dove_tpu_torch.models.wan_vae import WanVAE_

    models = []
    for cls, c, stream in ((WanModel, cfg.dit, weights.DIT), (WanVAE_, cfg.vae, weights.VAE)):
        with torch.device("meta"):
            m = cls(c, dtype=dtype)
        spec = [(k, tuple(t.shape)) for k, t in m.state_dict().items()]
        m.load_state_dict(weights.make(spec, seed, stream, dtype, device), assign=True)
        models.append(m.eval().requires_grad_(False))
    return models


def prompt(seed: int, dit: dict, dtype, device) -> torch.Tensor:
    """The empty prompt's umT5 embedding [text_len, text_dim]: its one token
    N(0, 1) from the seed, then zero rows."""
    row = weights.prompt_embedding(seed, 1, dit["text_dim"], dtype, device)
    return torch.cat([row, row.new_zeros((dit["text_len"] - 1, dit["text_dim"]))])


class Job:
    def __init__(self, cell):
        from dove_tpu_torch.pipeline import DovePipeline

        self.cell = cell
        if cell.variant not in (None,) + tuple(LOWERED):
            raise ValueError(f"unknown variant {cell.variant!r}")
        cfg = pipeline_config(cell.config)
        dit, vae = build_models(cfg, cell.seed, cell.dtype, cell.device)
        self.pipe = DovePipeline(
            config=cfg, dit=dit, vae=vae,
            prompt_embedding=prompt(cell.seed, cell.config["dit"], cell.dtype, cell.device),
            dtype=cell.dtype, device=cell.device, vae_tiling=True, output_uint8=True)
        del dit, vae
        mix = cell.mix
        self.shape = (mix["frames"], mix["height"], mix["width"])
        self.outputs: list[np.ndarray] = []
        _plant(self.pipe, cell.fault)
        n = 1
        if cell.warm:
            t0 = time.perf_counter()
            self._run(clip(cell.seed, 1 << 20, *self.shape), 1 << 20)
            n = max(1, math.ceil(cell.seconds / (time.perf_counter() - t0)))
        self.clips = {i: clip(cell.seed, i, *self.shape) for i in range(n)}

    def _run(self, frames: np.ndarray, index: int) -> np.ndarray:
        return self.pipe.process_frames(
            frames, seed=weights.derive(self.cell.seed, weights.CLIP, index, 1))

    def step(self, i: int) -> dict:
        frames = self.clips.pop(i, None)
        if frames is None:
            frames = clip(self.cell.seed, i, *self.shape)
        out = self._run(frames, i)
        self.outputs.append(out)
        return dict(self.pipe.stage_times, units=out.shape[0])

    def check(self) -> dict:
        cell = self.cell
        i = weights.derive(cell.seed, 7) % len(self.outputs)
        got = self.outputs[i]
        self.outputs = []
        del self.pipe
        gc.collect()
        if cell.device.type == "cuda":
            torch.cuda.empty_cache()
        strict_fp32()
        c = cell.config
        dit_w = weights.make(ref.dit_spec(c["dit"]), cell.seed, weights.DIT, cell.dtype,
                             cell.device)
        vae_w = weights.make(ref.vae_spec(c["vae"]), cell.seed, weights.VAE, cell.dtype,
                             cell.device)
        args = (dit_w, vae_w, c, clip(cell.seed, i, *self.shape),
                prompt(cell.seed, c["dit"], cell.dtype, cell.device))
        want = ref.wan_clip(*args)
        if cell.variant in LOWERED:
            got = ref.wan_clip(*args, **LOWERED[cell.variant])
        return gaps(got, want)


def _plant(pipe, fault: str | None) -> None:
    """Faults for the harness's own tests, planted under the timed path."""
    if fault == "state_unchanged":  # the DiT step hands back its input latent
        pipe.dit.forward = lambda latent, *a, **k: torch.zeros_like(latent, dtype=torch.float32)
    else:
        serve_clip._plant(pipe, fault)
