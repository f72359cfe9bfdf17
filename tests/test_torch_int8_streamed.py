"""Parity of the port's streamed long-clip path with dove_tpu under the int8
serving modes.

The streamed cases of tests/test_torch_int8_pipeline.py, in a file of their
own so that the two halves run on different workers: fp32 on the CPU,
tiny_test() weights, the posterior mean on both sides; the fixtures and
bars are that file's.
"""

from __future__ import annotations

import pytest
import torch

from test_torch_int8_pipeline import (  # noqa: F401 (fixtures)
    _assert_int8_vae_parity,
    _clip,
    _pipes,
    _wide_pipes,
    _within_one_lsb,
    models,
    wide_models,
)
from torch_threads import two_torch_threads  # noqa: F401 (autouse)

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


@pytest.mark.parametrize("mode,overlap_t,windows", [
    ("int8-dit", None, None), ("int8w", 12, (5, 5)),
])
def test_streamed_clip_matches_jax(models, mode, overlap_t, windows):
    """41 frames (11 latents) on an odd-sized frame, streamed on both sides:
    a 33-frame and an 8-frame segment with the causal caches carried across,
    and two overlapping 10-latent DiT windows (overlap 2, or 3 from
    overlap_t=12 pixel frames). With 5x5-latent windows on both sides the
    7x9-latent frame takes 2x3 encode and decode windows, so the
    window-major groups (4 + 2 encode, 2 + 2 + 2 decode) and the feathered
    assembly of each segment run too."""
    jp, tp = _pipes(models, quantize=mode, streaming="on")
    if windows is not None:
        for pipe in (jp, tp):
            pipe._window_budget = lambda: (2, windows, windows)
    streamed = []
    run = tp._sr_clip_streamed
    tp._sr_clip_streamed = lambda *a, **kw: streamed.append(kw) or run(*a, **kw)
    frames = _clip(41, 14, 18, 4)
    ref = jp.process_frames(frames, seed=0, overlap_t=overlap_t)
    ours = tp.process_frames(frames, seed=0, overlap_t=overlap_t)
    assert streamed == [{"overlap_lat": None if overlap_t is None else 3}]
    assert ours.shape == (41, 56, 72, 3)
    _within_one_lsb(ours, ref)
    assert set(tp.stage_times) == {
        "prep", "enc", "enc.upload", "enc.upscale", "enc.windows", "enc.assemble", "dit",
        "dec", "dec.windows", "dec.assemble", "dec.download", "finish", "dit.dequantize",
        } | ({"dit.quantize"} if mode == "int8-dit" else set()) | {
        f"{s}.{c}" for s in ("enc", "dec") for c in ("windows_n", "window_px", "frame_px")}


def test_int8_streamed_clip_matches_jax(wide_models):
    """quantize="int8" streams by default: 37 frames pad to 41, a 33-frame and
    an 8-frame segment with the int8 convs' causal caches carried across (a
    4x4 frame: XLA:CPU's int8 convolution is slow)."""
    jp, tp = _wide_pipes(wide_models, quantize="int8")
    jf, tf = _wide_pipes(wide_models, streaming="on")
    streamed = []
    run = tp._sr_clip_streamed
    tp._sr_clip_streamed = lambda *a, **kw: streamed.append(kw) or run(*a, **kw)
    frames = _clip(37, 4, 4, 10)
    ours = tp.process_frames(frames, seed=0)
    assert streamed == [{"overlap_lat": None}] and ours.shape == (37, 16, 16, 3)
    _assert_int8_vae_parity(ours, jp.process_frames(frames, seed=0),
                            tf.process_frames(frames, seed=0),
                            jf.process_frames(frames, seed=0), float_encoder=False)
