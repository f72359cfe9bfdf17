"""Parity of the port's int8-DiT serving modes and streamed path with dove_tpu.

fp32 on the CPU, tiny_test() weights, the posterior mean on both sides (the
two frameworks' RNGs cannot match). Each side quantizes the same fp32 DiT
with its own ``quantize_dit``; the codes come out identical
(tests/test_torch_quant.py). uint8 outputs agree within one LSB.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dove_tpu import config as jcfg
from dove_tpu import pipeline as jpipeline
from dove_tpu.models import dit as jdit
from dove_tpu.models import vae as jvae
from dove_tpu.pipeline import DovePipeline as JPipeline
from dove_tpu_torch import config as tcfg
from dove_tpu_torch import pipeline as tpipeline
from dove_tpu_torch import weights as tweights
from dove_tpu_torch.ops import flash_attention as fa
from dove_tpu_torch.ops import quant
from dove_tpu_torch.pipeline import DovePipeline

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


@pytest.fixture(scope="module")
def models():
    cfg_j = jcfg.tiny_test()
    dit_tree = jax.tree.map(np.asarray,
                            jdit.init_dit_params(jax.random.PRNGKey(0), cfg_j.dit))
    vae_tree = jax.tree.map(np.asarray,
                            jvae.init_vae_params(jax.random.PRNGKey(1), cfg_j.vae))
    prompt = np.random.default_rng(0).standard_normal((7, 32)).astype(np.float32)
    return cfg_j, dit_tree, vae_tree, prompt


def _torch_pipe(models, **flags) -> DovePipeline:
    _, dit_tree, vae_tree, prompt = models
    dit, vae = tweights.from_jax_params(tcfg.tiny_test(), dit_tree, vae_tree)
    return DovePipeline(
        config=tcfg.tiny_test(), dit=dit, vae=vae,
        prompt_embedding=torch.from_numpy(prompt), dtype=torch.float32,
        device="cpu", sample_posterior=False, output_uint8=True, **flags,
    )


def _pipes(models, **flags):
    cfg_j, dit_tree, vae_tree, prompt = models
    jp = JPipeline(
        config=cfg_j, dit_params=jax.tree.map(jnp.asarray, dit_tree),
        vae_params=jax.tree.map(jnp.asarray, vae_tree),
        prompt_embedding=jnp.asarray(prompt), dtype=jnp.float32,
        sample_posterior=False, vae_tiling=True, donate_weights=False,
        output_uint8=True, **flags,
    )
    return jp, _torch_pipe(models, **flags)


def _clip(frames: int, h: int, w: int, seed: int) -> np.ndarray:
    return np.random.default_rng(seed).uniform(0, 1, (frames, h, w, 3)).astype(np.float32)


def _within_one_lsb(ours: np.ndarray, ref: np.ndarray) -> None:
    assert ours.shape == ref.shape and ours.dtype == ref.dtype == np.uint8
    assert np.abs(ours.astype(int) - ref.astype(int)).max() <= 1


@pytest.mark.parametrize("mode", ["int8-dit", "int8w"])
def test_quantized_process_frames_matches_jax(models, mode):
    """9 frames of 64x64: one pass, a 2x2-window decode; the DiT's six hot
    linears per block are int8 on both sides."""
    jp, tp = _pipes(models, quantize=mode)
    cls = quant.QLinear if mode == "int8-dit" else quant.W8Linear
    assert sum(isinstance(m, cls) for m in tp.dit.modules()) == 6 * tp.config.dit.num_layers
    assert tp.attention_backend is None  # the CPU keeps the automatic dispatch
    frames = _clip(9, 64, 64, 2)
    ref = jp.process_frames(frames, seed=0)
    ours = tp.process_frames(frames, seed=0)
    assert ours.shape == (9, 256, 256, 3)
    _within_one_lsb(ours, ref)


def test_flash_qk8_process_frames_matches_jax(models):
    """K2 on both sides: its plain version here, the Pallas kernel in
    interpret mode there."""
    jp, tp = _pipes(models, quantize="int8-dit", attention_backend="flash-qk8")
    frames = _clip(9, 16, 24, 3)
    fa.launches_qk8.reset()
    ref = jp.process_frames(frames, seed=0)
    ours = tp.process_frames(frames, seed=0)
    assert ours.shape == (9, 64, 96, 3)
    _within_one_lsb(ours, ref)
    assert fa.launches_qk8.count == 0  # the CPU runs the plain version


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
    assert set(tp.stage_times) == {"enc", "dit", "dec"}


@pytest.mark.parametrize("flags,budget", [
    ({}, (2, (32, 32), (28, 28))),
    ({"quantize": "int8-dit"}, (2, (40, 38), (36, 34))),
    ({"quantize": "int8w"}, (2, (40, 38), (36, 34))),
    ({"quantize": "int8-dit", "dec_window_cap": (30, 40)}, (2, (40, 38), (30, 34))),
    ({"dec_window_cap": (3, 40)}, (2, (32, 32), (3, 28))),
])
def test_window_budget_matches_jax(models, flags, budget):
    """(feather band, encode window, decode window) in latents: the JAX
    package's 16 GB plans, capped by dec_window_cap."""
    jp, tp = _pipes(models, **flags)
    assert tp._window_budget() == jp._window_budget() == budget


def test_stream_plans_match_jax():
    for frames in range(1, 330, 4):
        assert tpipeline.plan_stream_segments(frames) == jpipeline.plan_stream_segments(frames)
    for n_lat in range(1, 90):
        for window, overlap in ((10, 2), (10, 3), (10, 0), (6, 5), (4, 9)):
            assert (tpipeline.plan_dit_windows(n_lat, window, overlap)
                    == jpipeline.plan_dit_windows(n_lat, window, overlap))
    # 100 frames pad to 105 = 27 latents: four 10-latent windows
    assert len(tpipeline.plan_dit_windows(27, 10, 2)) == 4
    with pytest.raises(ValueError):
        tpipeline.plan_stream_segments(42)


def test_streaming_switch(models):
    tp = _torch_pipe(models)
    for value, want in (("auto", False), ("on", True), ("off", False),
                        (True, True), (False, False)):
        assert dataclasses.replace(tp, streaming=value)._stream_enabled() is want
    q = _torch_pipe(models, quantize="int8w")  # auto: on for an int8 DiT
    assert q._stream_enabled() and not dataclasses.replace(q, streaming="off")._stream_enabled()
    with pytest.raises(ValueError, match="auto/on/off"):
        dataclasses.replace(tp, streaming="sometimes")


def test_unported_and_unknown_quantize_modes_raise(models):
    tp = _torch_pipe(models)
    for mode in ("int8", "int8-vae", "int8-dit-dec"):
        with pytest.raises(NotImplementedError, match="K4"):
            dataclasses.replace(tp, quantize=mode)
    with pytest.raises(ValueError, match="unknown quantize mode"):
        dataclasses.replace(tp, quantize="int4")
    with pytest.raises(ValueError, match="dec_window_cap"):
        dataclasses.replace(tp, dec_window_cap=(2, 30))


def test_inference_cli_int8_streamed_on_cpu(tmp_path):
    """python -m dove_tpu_torch.inference --quantize int8-dit on the CPU:
    a 37-frame clip pads to 41 and streams (auto), one 4x mp4 out."""
    from dove_tpu_torch import inference
    from dove_tpu_torch.io import video as video_io

    src = tmp_path / "in"
    src.mkdir()
    video_io.save_video(_clip(37, 16, 24, 5), src / "clip.mp4")
    out = tmp_path / "out"
    args = ["--input_dir", str(src), "--output_path", str(out), "--is_vae_st",
            "--device", "cpu", "--preset", "tiny", "--dtype", "float32",
            "--quantize", "int8-dit"]
    assert inference.build_parser().parse_args(args).streaming == "auto"
    inference.main(args)
    frames = video_io.read_video_frames(out / "clip.mp4")
    assert frames.shape == (37, 64, 96, 3)
