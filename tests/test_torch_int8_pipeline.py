"""Parity of the port's int8 serving modes and streamed path with dove_tpu
(the streamed clips are in tests/test_torch_int8_streamed.py, which takes its
fixtures from here).

fp32 on the CPU, tiny_test() weights, the posterior mean on both sides (the
two frameworks' RNGs cannot match). Each side quantizes the same fp32 DiT
with its own ``quantize_dit``; the codes come out identical
(tests/test_torch_quant.py). uint8 outputs agree within one LSB.

The int8 VAE modes (``int8``, ``int8-vae``, ``int8-dit-dec``) run on a VAE
whose three lower levels are 64 channels wide, the least the quantization
policy selects; each side quantizes it with its own ``quantize_vae`` (equal
codes without calibration: tests/test_torch_vae_quant.py). A forward
through several quantized convs is ill-conditioned on both sides (see
``_assert_int8_vae_parity``), so those outputs are held by what the
quantization error itself allows, not by one LSB.
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
from torch_threads import two_torch_threads  # noqa: F401 (autouse)

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
        device="cpu", sample_posterior=False, vae_tiling=True,
        output_uint8=True, **flags,
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


WIDE_VAE = dict(latent_channels=8, block_out_channels=(8, 8, 64, 64),
                layers_per_block=1, norm_num_groups=4, sample_frames_batch_size=8,
                latent_frames_batch_size=2, tile_sample_min_height=32,
                tile_sample_min_width=32)


def _wide_cfg(mod, chans=WIDE_VAE["block_out_channels"]):
    vae = mod.VAEConfig(**{**WIDE_VAE, "block_out_channels": chans})
    return dataclasses.replace(mod.tiny_test(), vae=vae)


def _wide_models(chans):
    cfg_j = _wide_cfg(jcfg, chans)
    dit_tree = jax.tree.map(np.asarray,
                            jdit.init_dit_params(jax.random.PRNGKey(0), cfg_j.dit))
    vae_tree = jax.tree.map(np.asarray,
                            jvae.init_vae_params(jax.random.PRNGKey(2), cfg_j.vae))
    prompt = np.random.default_rng(0).standard_normal((7, 32)).astype(np.float32)
    return cfg_j, dit_tree, vae_tree, prompt


@pytest.fixture(scope="module")
def wide_models():
    """tiny_test() with a VAE the policy quantizes: the two lower levels are
    64 channels wide (8 encoder and 14 decoder convs)."""
    return _wide_models(WIDE_VAE["block_out_channels"])


def _wide_pipes(wide_models, windows=None, **flags):
    cfg_j, dit_tree, vae_tree, prompt = wide_models
    jp = JPipeline(
        config=cfg_j, dit_params=jax.tree.map(jnp.asarray, dit_tree),
        vae_params=jax.tree.map(jnp.asarray, vae_tree),
        prompt_embedding=jnp.asarray(prompt), dtype=jnp.float32,
        sample_posterior=False, vae_tiling=True, donate_weights=False,
        output_uint8=True, **flags,
    )
    cfg_t = _wide_cfg(tcfg, cfg_j.vae.block_out_channels)
    dit, vae = tweights.from_jax_params(cfg_t, dit_tree, vae_tree)
    if flags.get("vae_calib") is not None:
        flags = {**flags, "vae_calib": {k: torch.tensor(np.asarray(v))
                                        for k, v in flags["vae_calib"].items()}}
    tp = DovePipeline(
        config=cfg_t, dit=dit, vae=vae, prompt_embedding=torch.from_numpy(prompt),
        dtype=torch.float32, device="cpu", sample_posterior=False,
        vae_tiling=True, output_uint8=True, **flags,
    )
    if windows is not None:
        for pipe in (jp, tp):
            pipe._window_budget = lambda: (2, windows, windows)
    return jp, tp


def _n_qconvs(module) -> int:
    return sum(isinstance(m, quant.QConv3d) for m in module.modules())


def _clip(frames: int, h: int, w: int, seed: int) -> np.ndarray:
    return np.random.default_rng(seed).uniform(0, 1, (frames, h, w, 3)).astype(np.float32)


def _within_one_lsb(ours: np.ndarray, ref: np.ndarray) -> None:
    assert ours.shape == ref.shape and ours.dtype == ref.dtype == np.uint8
    assert np.abs(ours.astype(int) - ref.astype(int)).max() <= 1


def _lsb_diff(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    assert a.shape == b.shape and a.dtype == b.dtype == np.uint8
    return np.abs(a.astype(int) - b.astype(int))


def _assert_int8_vae_parity(ours, ref, ours_float, ref_float, float_encoder: bool) -> None:
    """A forward through several quantized convs is ill-conditioned in JAX as
    in the port: each conv's range search makes a discrete choice and each
    code a rounding, so an input moved by 1e-6 moves JAX's own uint8 output
    by several LSB in places (test_int8_dit_dec_lowres_calibrated_matches_jax
    measures it; tests/test_torch_vae_quant.py holds the single convs to
    1e-4). One LSB cannot hold between two frameworks. Held instead to the
    quantization error itself, on these seeded weights: the float pipelines
    agree within one LSB; both sides drift from the float output by the same
    mean (within 15%); the port is nearer to JAX's int8 output than the float
    output is, in the mean and at the worst pixel. With a float encoder (the
    decoder's error stays in the pixels and is not fed through the DiT) at
    most 1% of the values differ by more than one LSB."""
    _within_one_lsb(ours_float, ref_float)
    drift_ref, drift_ours = _lsb_diff(ref, ref_float), _lsb_diff(ours, ref_float)
    apart = _lsb_diff(ours, ref)
    assert drift_ref.max() > 1  # the mode does quantize something
    assert abs(drift_ours.mean() / drift_ref.mean() - 1.0) <= 0.15
    assert apart.mean() <= drift_ref.mean() and apart.max() <= drift_ref.max()
    if float_encoder:
        assert (apart > 1).mean() <= 0.01


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


@pytest.fixture(scope="module")
def wide_float_clip(wide_models):
    """The float pipelines' outputs (port, JAX) on the 5x8x12 clip of
    test_int8_vae_modes_match_jax: the same for each of its modes."""
    jf, tf = _wide_pipes(wide_models)
    frames = _clip(5, 8, 12, 6)
    return tf.process_frames(frames, seed=0), jf.process_frames(frames, seed=0)


@pytest.mark.parametrize("mode", ["int8", "int8-vae", "int8-dit-dec"])
def test_int8_vae_modes_match_jax(wide_models, wide_float_clip, mode):
    """5 frames of 8x12, one pass, one window: the VAE's 64-channel convs
    (k_t = 3, the upsamplers' k_t = 1 and, with an int8 encoder, the stride-2
    downsampler) are int8 on both sides."""
    jp, tp = _wide_pipes(wide_models, quantize=mode)
    enc_q = 0 if mode == "int8-dit-dec" else 8
    assert (_n_qconvs(tp.vae.encoder), _n_qconvs(tp.vae.decoder)) == (enc_q, 14)
    n_qlinear = sum(isinstance(m, quant.QLinear) for m in tp.dit.modules())
    assert n_qlinear == (0 if mode == "int8-vae" else 6 * tp.config.dit.num_layers)
    assert tp._stream_enabled() is (mode != "int8-vae")
    frames = _clip(5, 8, 12, 6)
    ours = tp.process_frames(frames, seed=0)
    assert ours.shape == (5, 32, 48, 3)
    _assert_int8_vae_parity(ours, jp.process_frames(frames, seed=0), *wide_float_clip,
                            float_encoder=mode == "int8-dit-dec")


def test_fused_path_under_int8_matches_jax(wide_models):
    """The fused outer-tile path under quantize="int8" (int8 DiT, encoder and
    decoder): 9 frames of 16x16 -> 64x64 in two 64x48 tiles, one call of
    batch 2, so the int8 convs run at the tile's shape on both sides. Float
    output, held as the staged int8 modes are, on its 8-bit rounding."""
    jp, tp = _wide_pipes(wide_models, quantize="int8")
    jf, tf = _wide_pipes(wide_models)
    assert (_n_qconvs(tp.vae.encoder), _n_qconvs(tp.vae.decoder)) == (8, 14)
    calls = []
    sr_tile = tp.sr_tile
    tp.sr_tile = lambda tile, gen: calls.append(tuple(tile.shape)) or sr_tile(tile, gen)
    frames = _clip(9, 16, 16, 11)
    kw = dict(seed=0, tile_size_hw=(64, 48), overlap_hw=(32, 32), tile_batch=2)
    outs = [p.process_frames(frames, **kw) for p in (tp, jp, tf, jf)]
    assert calls == [(2, 9, 64, 48, 3)]
    for out in outs:
        assert out.shape == (9, 64, 64, 3) and out.dtype == np.float32
    ours, ref, ours_float, ref_float = (
        np.round(np.asarray(o) * 255.0).astype(np.uint8) for o in outs)
    _assert_int8_vae_parity(ours, ref, ours_float, ref_float, float_encoder=False)


def test_int8_dit_dec_lowres_calibrated_matches_jax():
    """The recommended point: int8 DiT, int8 decoder with the "lowres" set
    kept float, equalized from a calibration run of the JAX decoder (amax
    stats; a tapcorr entry would add GPTQ rounding, whose codes two linear-
    algebra libraries do not reproduce bit for bit). On a VAE whose level 1
    is 64 wide too, so that the decoder's up.2 level (four convs and the
    full-resolution upsampler) stays quantized. Also measures what the bar of
    _assert_int8_vae_parity rests on: JAX's own output against JAX's on an
    input moved by 1e-6."""
    models = _wide_models((8, 64, 64, 64))
    cfg_j, _, vae_tree, _ = models
    lat = np.random.default_rng(7).standard_normal((1, 2, 4, 4, 8)).astype(np.float32)
    jt = jax.tree.map(jnp.asarray, vae_tree)
    _, calib = jvae.calibrate(
        lambda z: jvae.decoder_forward(cfg_j.vae, jt["decoder"], z, None), jnp.asarray(lat))
    calib = {k: np.asarray(v) for k, v in calib.items() if "#" not in k}
    flags = dict(quantize="int8-dit-dec", vae_exclude=("lowres",), vae_calib=calib)
    jp, tp = _wide_pipes(models, **flags)
    jf, tf = _wide_pipes(models)
    assert len(tp.vae_exclude) == 14 and tp.vae_exclude == jp.vae_exclude
    qconvs = [m for m in tp.vae.decoder.modules() if isinstance(m, quant.QConv3d)]
    assert len(qconvs) == 5 and all(m.equalize_inv is not None for m in qconvs)
    assert _n_qconvs(tp.vae.encoder) == 0
    assert isinstance(tp.vae.decoder.up_blocks[2].upsamplers[0].conv, quant.QConv3d)
    assert isinstance(tp.vae.decoder.mid_block.resnets[0].conv1.conv, torch.nn.Conv3d)
    frames = _clip(1, 8, 12, 8)  # a still: the least the slow XLA:CPU int8 conv allows
    ref = jp.process_frames(frames, seed=0)
    ours = tp.process_frames(frames, seed=0)
    _assert_int8_vae_parity(ours, ref, tf.process_frames(frames, seed=0),
                            jf.process_frames(frames, seed=0), float_encoder=True)
    moved = frames + np.random.default_rng(9).normal(0, 1e-6, frames.shape).astype(np.float32)
    own = _lsb_diff(jp.process_frames(moved, seed=0), ref)
    assert own.max() >= 1  # JAX against itself already moves
    assert _lsb_diff(ours, ref).mean() <= 2.0 * own.mean()


@pytest.mark.parametrize("flags,budget", [
    ({}, (2, (32, 32), (28, 28))),
    ({"quantize": "int8"}, (2, (46, 42), (46, 42))),
    ({"quantize": "int8-vae"}, (2, (32, 32), (28, 28))),
    ({"quantize": "int8-dit-dec"}, (2, (40, 38), (46, 42))),
    ({"quantize": "int8", "dec_window_cap": (30, 50)}, (2, (46, 42), (30, 42))),
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


def test_inference_cli_int8_dit_dec_lowres_on_cpu(tmp_path, monkeypatch):
    """--quantize int8-dit-dec --vae_exclude lowres --vae_calib npz on the
    CPU, the tiny preset given a VAE wide enough to quantize: the pipeline
    the CLI builds has an int8 DiT, a float encoder and the decoder's up.2
    level int8 and equalized; one 4x mp4 out."""
    from dove_tpu_torch import inference
    from dove_tpu_torch.io import video as video_io

    cfg = _wide_cfg(tcfg, (8, 64, 64, 64))
    monkeypatch.setattr(tcfg, "tiny_test", lambda: cfg)
    built = []
    load = inference.load_pipeline
    monkeypatch.setattr(inference, "load_pipeline", lambda a: built.append(load(a)) or built[-1])
    calib_path = tmp_path / "calib.npz"
    np.savez(calib_path, **{"decoder.up.2.res.0.conv1": np.full(64, 2.0, np.float32),
                            "decoder.up.2.upsample": np.linspace(0.5, 3, 64).astype(np.float32)})
    src = tmp_path / "in"
    src.mkdir()
    video_io.save_video(_clip(5, 8, 12, 11), src / "clip.mp4")
    out = tmp_path / "out"
    inference.main(["--input_dir", str(src), "--output_path", str(out), "--is_vae_st",
                    "--device", "cpu", "--preset", "tiny", "--dtype", "float32",
                    "--quantize", "int8-dit-dec", "--vae_exclude", "lowres",
                    "--vae_calib", str(calib_path)])
    (pipe,) = built
    assert _n_qconvs(pipe.vae.encoder) == 0 and _n_qconvs(pipe.vae.decoder) == 5
    up2 = pipe.vae.decoder.up_blocks[2]
    assert up2.resnets[0].conv1.conv.equalize_inv is not None
    assert up2.upsamplers[0].conv.equalize_inv is not None
    assert up2.resnets[0].conv2.conv.equalize_inv is None  # no entry in the npz
    assert sum(isinstance(m, quant.QLinear) for m in pipe.dit.modules()) == 12
    assert video_io.read_video_frames(out / "clip.mp4").shape == (5, 32, 48, 3)
    with pytest.raises(SystemExit):  # an unknown mode is refused by the parser
        inference.build_parser().parse_args(["--input_dir", "a", "--output_path", "b",
                                             "--quantize", "int4"])
