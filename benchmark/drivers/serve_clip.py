"""Offline restoration of LQ clips through ``DovePipeline.process_frames``.

A closed loop: seeded clips of the mix's frames x height x width go through
the program one after another, as an offline job over a test set runs them.
One unit of work is one clip; the rate is its output frames per second.

Set-up: the weights and the empty-prompt embedding are made on the device
from the seed, the pipeline is built in the mix's mode, one warm clip of the
same shape runs, and the window's clips are made on the host. The check samples one clip of the window from the seed,
frees the program, makes the same weights again and runs the plain float32
reference on the same clip and noise seed; it compares the uint8 frames:
the RMS gap over the clip and over its worst frame, in LSB.
"""

from __future__ import annotations

import gc
import math
import time

import numpy as np
import torch
import torch.nn.functional as F

from benchmark import weights
from benchmark.program import build_models, pipeline_config
from benchmark.reference.models import fp8_conv3d, fp8_linear, int4_linear
from benchmark.reference.serve import staged_clip

RATE = "frames_per_s"
# controls: the program's int8 modes in place of the configured one, or the
# reference in the program's place with float8 (int4) DiT linears or float8
# VAE convolutions
LOWERED = {"fp8": dict(linear=fp8_linear), "int4": dict(linear=int4_linear),
           "fp8-vae": dict(conv3d=fp8_conv3d)}
VARIANTS = ("int8", "int8-dit") + tuple(LOWERED)


def clip(seed: int, index: int, frames: int, h: int, w: int) -> np.ndarray:
    """A seeded LQ clip [frames, h, w, 3] float32 in [0, 1]: a smooth random
    field moving through time with fine noise on it."""
    gen = torch.Generator().manual_seed(weights.derive(seed, weights.CLIP, index))
    coarse = torch.rand((1, 3, frames // 4 + 2, h // 12 + 2, w // 12 + 2), generator=gen)
    smooth = F.interpolate(coarse, size=(frames, h, w), mode="trilinear", align_corners=False)
    fine = torch.rand((1, 3, frames, h, w), generator=gen)
    x = (0.85 * smooth + 0.15 * fine)[0].permute(1, 2, 3, 0)
    return x.contiguous().numpy()


class Job:
    def __init__(self, cell):
        from dove_tpu_torch.pipeline import DovePipeline

        self.cell = cell
        mix, cfg = cell.mix, pipeline_config(cell.config)
        mode = mix.get("quantize")
        if cell.variant not in (None,) + VARIANTS:
            raise ValueError(f"unknown variant {cell.variant!r}")
        if cell.variant in ("int8", "int8-dit"):
            mode = cell.variant
        dit, vae = build_models(cfg, cell.seed, cell.dtype, cell.device)
        prompt = weights.prompt_embedding(cell.seed, cfg.dit.max_text_seq_length,
                                          cfg.dit.text_embed_dim, cell.dtype, cell.device)
        self.pipe = DovePipeline(
            config=cfg, dit=dit, vae=vae, prompt_embedding=prompt, dtype=cell.dtype,
            device=cell.device, vae_tiling=mix["path"] == "staged", output_uint8=True,
            quantize=mode)
        del dit, vae
        self.shape = (mix["frames"], mix["height"], mix["width"])
        self.outputs: list[np.ndarray] = []
        _plant(self.pipe, cell.fault)
        n = 1
        if cell.warm:
            t0 = time.perf_counter()
            self._run(clip(cell.seed, 1 << 20, *self.shape), 1 << 20)
            n = max(1, math.ceil(cell.seconds / (time.perf_counter() - t0)))
        # the window's clips, made before it: the window times the program alone
        self.clips = {i: clip(cell.seed, i, *self.shape) for i in range(n)}

    def _run(self, frames: np.ndarray, index: int) -> np.ndarray:
        return self.pipe.process_frames(
            frames, seed=weights.derive(self.cell.seed, weights.CLIP, index, 1))

    def step(self, i: int) -> dict:
        frames = self.clips.pop(i, None)
        if frames is None:  # a window that outran the set-up's estimate
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
        dit_w, vae_w, prompt = weights.for_reference(cell.config, cell.seed, cell.dtype,
                                                     cell.device)
        args = (dit_w, vae_w, cell.config, clip(cell.seed, i, *self.shape), prompt,
                weights.derive(cell.seed, weights.CLIP, i, 1), cell.mix.get("quantize"))
        want = staged_clip(*args)
        if cell.variant in LOWERED:
            got = staged_clip(*args, **LOWERED[cell.variant])
        return gaps(got, want)


def gaps(got: np.ndarray, want: np.ndarray) -> dict:
    """RMS of the uint8 difference over the clip and over its worst frame."""
    if got.shape != want.shape:
        return {"rms_lsb": float("inf"), "worst_frame_rms_lsb": float("inf")}
    d = got.astype(np.float64) - want.astype(np.float64)
    per_frame = np.sqrt(np.mean(d * d, axis=(1, 2, 3)))
    return {"rms_lsb": float(np.sqrt(np.mean(d * d))),
            "worst_frame_rms_lsb": float(per_frame.max())}


def _plant(pipe, fault: str | None) -> None:
    """Faults for the harness's own tests, planted under the timed path."""
    if fault is None:
        return
    if fault == "state_unchanged":  # the DiT step hands back its input latent
        sf = pipe.config.vae.scaling_factor
        pipe._denoise = lambda latent, *a, **k: latent / torch.tensor(sf, dtype=latent.dtype)
    elif fault == "answer_altered":  # one frame of the clip altered where it is made
        orig = pipe.quantize_frames

        def altered(out01):
            out = orig(out01)
            out[:, out.shape[1] // 2] = 255 - out[:, out.shape[1] // 2]
            return out
        pipe.quantize_frames = altered
    else:
        raise ValueError(f"unknown fault {fault!r}")

