"""Parity of the PyTorch port's pipeline with dove_tpu's (fp32, CPU).

The staged path: a 9-frame 64x64 LQ clip makes a 256x256 output and a 32x32
latent, so the decode stage plans 2x2 windows and the feathered assembly
runs. The fused outer-tile path: untiled, in spatial tiles and temporal
chunks, batched with a padded last batch, with noise added at noise_step,
and at upscale 1. Both sides take the posterior mean (the two frameworks'
RNGs cannot match) and the same tiny_test() weights. Float outputs are held
at atol 1e-4; quantized outputs within one LSB, since a 1e-6 difference can
move a value across a rounding boundary.
"""

from __future__ import annotations

import dataclasses
import json
import os
import re
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dove_tpu import config as jcfg
from dove_tpu.models import dit as jdit
from dove_tpu.models import vae as jvae
from dove_tpu.pipeline import DovePipeline as JPipeline
from dove_tpu_torch import config as tcfg
from dove_tpu_torch import weights as tweights
from dove_tpu_torch.pipeline import DovePipeline, plan_axis
from torch_threads import two_torch_threads  # noqa: F401 (autouse)

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

REPO = Path(__file__).resolve().parents[1]
ATOL = 1e-4
LSB = 1.0 / 255.0


@pytest.fixture(scope="module")
def models():
    cfg_j = jcfg.tiny_test()
    dit_tree = jax.tree.map(np.asarray,
                            jdit.init_dit_params(jax.random.PRNGKey(0), cfg_j.dit))
    vae_tree = jax.tree.map(np.asarray,
                            jvae.init_vae_params(jax.random.PRNGKey(1), cfg_j.vae))
    prompt = np.random.default_rng(0).standard_normal((7, 32)).astype(np.float32)
    return cfg_j, dit_tree, vae_tree, prompt


def _pipes(models, **flags):
    cfg_j, dit_tree, vae_tree, prompt = models
    jp = JPipeline(
        config=cfg_j, dit_params=jax.tree.map(jnp.asarray, dit_tree),
        vae_params=jax.tree.map(jnp.asarray, vae_tree),
        prompt_embedding=jnp.asarray(prompt), dtype=jnp.float32,
        sample_posterior=False, vae_tiling=True, donate_weights=False, **flags,
    )
    cfg_t = tcfg.tiny_test()
    dit, vae = tweights.from_jax_params(cfg_t, dit_tree, vae_tree)
    tp = DovePipeline(
        config=cfg_t, dit=dit, vae=vae, prompt_embedding=torch.from_numpy(prompt),
        dtype=torch.float32, device="cpu", sample_posterior=False,
        vae_tiling=True, **flags,
    )
    return jp, tp


def _clip(frames: int, h: int, w: int, seed: int) -> np.ndarray:
    return np.random.default_rng(seed).uniform(0, 1, (frames, h, w, 3)).astype(np.float32)


def test_decode_plans_feathered_windows():
    assert plan_axis(32, 2, 28) == (17, 15, 2)
    assert plan_axis(32, 2, 32) == (32, 32, 1)
    assert plan_axis(90, 2, 28) == JPipeline._plan_axis(90, 2, 28)
    assert plan_axis(160, 2, 32) == JPipeline._plan_axis(160, 2, 32)


def test_stages_match_jax_before_quantization(models):
    """enc_all, the DiT step and the windowed decode at atol 1e-4."""
    jp, tp = _pipes(models)
    # the JAX dec_all quantizes inside its program: trace it without that
    jp._quantize_frames = lambda out01: out01
    fns = jp._staged_fns()
    lq = _clip(9, 64, 64, 1)[None] * 2.0 - 1.0

    m_ref = fns["enc_all"](jp.vae_params, jnp.asarray(lq))
    z_ref = fns["dit"](jp.dit_params, jp.prompt_embedding, m_ref,
                       jax.random.PRNGKey(0))
    px_ref = fns["dec_all"](jp.vae_params, z_ref)
    with torch.inference_mode():
        m = tp.enc_all(torch.from_numpy(lq))
        z = tp.dit_step(torch.tensor(np.asarray(m_ref)))
        px = tp.dec_float(torch.tensor(np.asarray(z_ref)))
    assert m.shape == m_ref.shape == (1, 3, 32, 32, 16)
    np.testing.assert_allclose(m.numpy(), np.asarray(m_ref), atol=ATOL, rtol=0)
    np.testing.assert_allclose(z.numpy(), np.asarray(z_ref), atol=ATOL, rtol=0)
    assert px.shape == px_ref.shape == (1, 9, 256, 256, 3)
    np.testing.assert_allclose(px.numpy(), np.asarray(px_ref), atol=ATOL, rtol=0)


@pytest.mark.parametrize("flags", [
    {"output_uint8": False},
    {"output_uint8": True},
    {"output_uint8": True, "output_i420": True},
])
def test_process_frames_matches_jax(models, flags):
    jp, tp = _pipes(models, **flags)
    frames = _clip(9, 64, 64, 2)
    ref = jp.process_frames(frames, seed=0)
    ours = tp.process_frames(frames, seed=0)
    assert ours.shape == ref.shape and ours.dtype == ref.dtype
    expect = (9, 384, 256) if flags.get("output_i420") else (9, 256, 256, 3)
    assert ours.shape == expect
    if ours.dtype == np.uint8:
        assert np.abs(ours.astype(int) - ref.astype(int)).max() <= 1
    else:
        np.testing.assert_allclose(ours, ref, atol=LSB + 1e-6, rtol=0)
    # one encode window (no assembly), 2x2 decode windows
    assert set(tp.stage_times) == {
        "prep", "enc", "enc.upload", "enc.upscale", "enc.windows", "dit", "dec",
        "dec.windows", "dec.assemble", "dec.download", "finish"} | {
        f"{s}.{c}" for s in ("enc", "dec") for c in ("windows_n", "window_px", "frame_px")}


def test_multi_chunk_clip_matches_jax(models):
    """41 frames: two overlapping 33-frame passes, trimmed at the overlap
    midpoint, on a padded (odd-sized) frame."""
    jp, tp = _pipes(models, output_uint8=True)
    frames = _clip(41, 14, 18, 3)
    ref = jp.process_frames(frames, seed=0)
    ours = tp.process_frames(frames, seed=0)
    assert ours.shape == ref.shape == (41, 56, 72, 3)
    assert np.abs(ours.astype(int) - ref.astype(int)).max() <= 1


def test_unported_paths_raise(models):
    """The mesh routes the JAX package refuses, the port refuses too: a
    "model" axis (tensor parallelism) off the staged path, and a TP degree
    that does not divide the heads (tiny_test has 4). The meshes are built
    by hand: the refusals come before any collective (the multi-rank runs
    are tests/test_torch_parallel.py's)."""
    from dove_tpu.parallel.mesh import make_mesh as jmesh
    from dove_tpu_torch.parallel.mesh import Mesh

    jp, tp = _pipes(models)
    frames = _clip(1, 16, 16, 4)
    fused = dataclasses.replace(tp, vae_tiling=False)
    with pytest.raises(ValueError, match="requires the staged path"):
        fused.process_frames(frames, mesh=Mesh({"data": 1, "model": 2}, 0))
    with pytest.raises(ValueError, match="requires the staged path"):
        dataclasses.replace(jp, vae_tiling=False).process_frames(
            frames, mesh=jmesh(data=1, model=2))
    with pytest.raises(ValueError, match="tensor_parallel=3 must divide"):
        tp.process_frames(frames, mesh=Mesh({"data": 1, "model": 3}, 0))
    with pytest.raises(ValueError, match="tensor_parallel=3 must divide"):
        jp.process_frames(frames, mesh=jmesh(data=1, model=3))


# The fused outer-tile path. Each case keeps to one or two tile geometries
# (JAX compiles once per geometry): 17 frames in 8-frame chunks with an
# overlap of 4 are chunks of 8, 8 and 9 frames; a 64x96 output at 64x64 tiles
# with a 32-pixel overlap is two tiles, a 64x128 one three.
FUSED_CASES = {
    "untiled": (9, 16, 16, {}),
    "tiles_and_chunks": (17, 16, 24, dict(tile_size_hw=(64, 64), chunk_len=8,
                                          overlap_t=4)),
    "tile_batch_padded": (9, 16, 32, dict(tile_size_hw=(64, 64), tile_batch=2)),
    "noise_step": (9, 16, 16, {}),
    "upscale_1": (9, 32, 32, dict(upscale=1)),
}
NOISE_STEP = 100

# The JAX side of the fused cases, in a process of its own: tests/conftest.py
# compiles this process's XLA programs at --xla_backend_optimization_level=0,
# and the tiny random encoder amplifies rounding ~100x, so that on the 8-frame
# chunks JAX at level 0 is 2.3e-4 from JAX as it serves (the default level),
# past the 1e-4 bar. The reference is JAX as it serves.
_JAX_FUSED = """
import json, sys
import jax
jax.config.update("jax_platforms", "cpu")
import jax.numpy as jnp
import numpy as np
from dove_tpu import config as jcfg
from dove_tpu.models import dit as jdit, vae as jvae
from dove_tpu.pipeline import DovePipeline
cases, noise_step, out = json.loads(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
cfg = jcfg.tiny_test()
dit = jdit.init_dit_params(jax.random.PRNGKey(0), cfg.dit)
vae = jvae.init_vae_params(jax.random.PRNGKey(1), cfg.vae)
prompt = np.random.default_rng(0).standard_normal((7, 32)).astype(np.float32)
drawn = []
def normal(key, shape, dtype=jnp.float32):
    drawn.append(list(shape))
    return jnp.asarray(np.random.default_rng(7).standard_normal(tuple(shape)), dtype)
jax.random.normal = normal
res = {}
for name, (n, h, w, kw) in cases.items():
    step = noise_step if name == "noise_step" else 0
    import dataclasses
    pipe = DovePipeline(config=dataclasses.replace(cfg, noise_step=step),
                        dit_params=dit, vae_params=vae,
                        prompt_embedding=jnp.asarray(prompt), dtype=jnp.float32,
                        sample_posterior=False, donate_weights=False)
    frames = np.random.default_rng(8).uniform(0, 1, (n, h, w, 3)).astype(np.float32)
    kw = {k: tuple(v) if isinstance(v, list) else v for k, v in kw.items()}
    res[name] = pipe.process_frames(frames, seed=0, **kw)
res["drawn"] = np.asarray(drawn)
np.savez(out, **res)
"""


@pytest.fixture(scope="module")
def jax_fused(tmp_path_factory):
    out = tmp_path_factory.mktemp("fused") / "ref.npz"
    env = dict(os.environ)
    env["XLA_FLAGS"] = " ".join(
        f for f in env.get("XLA_FLAGS", "").split()
        if not f.startswith("--xla_backend_optimization_level"))
    res = subprocess.run(
        [sys.executable, "-c", _JAX_FUSED, json.dumps(FUSED_CASES),
         str(NOISE_STEP), str(out)],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-4000:]
    return dict(np.load(out))


def _fused_pipe(models, noise_step: int = 0) -> DovePipeline:
    """The port's tiny_test() pipeline, from the weights JAX's pipeline
    makes (jax.random keys 0 and 1: the ``models`` fixture's trees), with the
    default vae_tiling."""
    _, dit_tree, vae_tree, prompt = models
    cfg_t = dataclasses.replace(tcfg.tiny_test(), noise_step=noise_step)
    dit, vae = tweights.from_jax_params(cfg_t, dit_tree, vae_tree)
    tp = DovePipeline(
        config=cfg_t, dit=dit, vae=vae, prompt_embedding=torch.from_numpy(prompt),
        dtype=torch.float32, device="cpu", sample_posterior=False,
    )
    assert not tp.vae_tiling  # the default is the fused path, as in JAX
    return tp


def _noise(shape) -> np.ndarray:
    return np.random.default_rng(7).standard_normal(tuple(shape)).astype(np.float32)


@pytest.mark.parametrize("case", list(FUSED_CASES))
def test_fused_path_matches_jax(models, jax_fused, case):
    """process_frames on the fused path, float output at atol 1e-4. With
    noise_step != 0 both sides add the same seeded noise at that step."""
    frames_n, h, w, kw = FUSED_CASES[case]
    tp = _fused_pipe(models, NOISE_STEP if case == "noise_step" else 0)
    drawn = []
    tp._draw_noise = lambda shape, gen: drawn.append(shape) or torch.from_numpy(
        _noise(shape))
    frames = np.random.default_rng(8).uniform(0, 1, (frames_n, h, w, 3)).astype(np.float32)
    ours = tp.process_frames(frames, seed=0, **kw)
    ref = jax_fused[case]
    u = kw.get("upscale", 4)
    assert ours.shape == ref.shape == (frames_n, h * u, w * u, 3)
    assert ours.dtype == np.float32
    np.testing.assert_allclose(ours, ref, atol=ATOL, rtol=0)
    if case == "noise_step":  # one draw each: [B, F' + 1 copy, C, h, w]
        assert drawn == [(1, 4, 8, 8, 8)]
        assert jax_fused["drawn"].tolist() == [[1, 4, 8, 8, 8]]
    else:
        assert drawn == []


def test_fused_batches_same_shaped_tiles(models, monkeypatch):
    """Three tiles of one geometry at tile_batch 2: two calls of batch 2, the
    second padded with a repeat whose output is dropped."""
    tp = _fused_pipe(models)
    batches = []
    sr_tile = tp.sr_tile
    monkeypatch.setattr(tp, "sr_tile", lambda tile, gen: batches.append(
        tuple(tile.shape)) or sr_tile(tile, gen))
    tp.process_frames(_clip(9, 16, 32, 8), tile_size_hw=(64, 64), tile_batch=2)
    assert batches == [(2, 9, 64, 64, 3), (2, 9, 64, 64, 3)]


def test_staged_matches_fused_when_untiled(models):
    """The port's staged path against its fused path on an untiled clip, at
    the JAX package's own bar (tests/test_pipeline.py): the staged path
    upscales on the device in the model's frame and returns uint8."""
    tp = _fused_pipe(models)
    frames = np.random.default_rng(0).random((9, 8, 8, 3)).astype(np.float32)
    out_fused = tp.process_frames(frames)
    out_staged = dataclasses.replace(tp, vae_tiling=True).process_frames(frames)
    assert out_fused.shape == out_staged.shape == (9, 32, 32, 3)
    np.testing.assert_allclose(out_fused, out_staged, atol=0.02)
    assert np.abs(out_fused - out_staged).mean() < 0.005


def test_device_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("the default device is usable here")
    from dove_tpu_torch.pipeline import resolve_device

    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device(None)
    assert resolve_device("cpu").type == "cpu"


def test_port_imports_no_jax():
    """Importing every module of the port (and chip_smoke.py) leaves jax and
    dove_tpu out of sys.modules; no source of theirs names them."""
    mods = sorted(
        ".".join(p.relative_to(REPO).with_suffix("").parts)
        for p in (REPO / "dove_tpu_torch").rglob("*.py")
    )
    assert {"dove_tpu_torch.eval.vgg", "dove_tpu_torch.eval.dists",
            "dove_tpu_torch.eval.lpips", "dove_tpu_torch.eval.metrics",
            "dove_tpu_torch.eval.color_fix", "dove_tpu_torch.eval_metrics",
            "dove_tpu_torch.tiling", "dove_tpu_torch.ops.resize",
            "dove_tpu_torch.eval.clip", "dove_tpu_torch.eval.clip_tokenizer",
            "dove_tpu_torch.eval.niqe", "dove_tpu_torch.eval.musiq",
            "dove_tpu_torch.eval.maniqa", "dove_tpu_torch.eval.ewarp",
            "dove_tpu_torch.models.raft", "dove_tpu_torch.int8_drift_report",
            "dove_tpu_torch.int8_weight_floor", "dove_tpu_torch.train.tracking",
            "dove_tpu_torch.models.t5", "dove_tpu_torch.models.flow_fusion",
            "dove_tpu_torch.encode_prompts", "dove_tpu_torch.prepare_sft_ckpt",
            "dove_tpu_torch.convert_frames_to_video"} <= set(mods)
    # nor cv2 or transformers (the card has neither): io/video.py imports
    # cv2 inside its video-file functions only
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m.removesuffix('.__init__'))\n"
        "import chip_smoke\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in"
        " ('jax', 'dove_tpu', 'cv2', 'transformers')]\n"
        "assert not bad, bad\n"
        "print('clean')\n"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "clean"
    pattern = re.compile(r"^\s*(import|from)\s+(jax|dove_tpu)(\.|\s|$)", re.M)
    for path in [REPO / "chip_smoke.py", *(REPO / "dove_tpu_torch").rglob("*.py")]:
        assert not pattern.search(path.read_text()), path


def test_inference_cli_tiny_on_cpu(tmp_path):
    """python -m dove_tpu_torch.inference on the CPU, tiny preset, seeded
    random weights: one clip in, one 4x mp4 out."""
    from dove_tpu_torch import inference
    from dove_tpu_torch.io import video as video_io

    src = tmp_path / "in"
    src.mkdir()
    video_io.save_video(_clip(9, 16, 24, 5), src / "clip.mp4")
    out = tmp_path / "out"
    inference.main(["--input_dir", str(src), "--output_path", str(out),
                    "--is_vae_st", "--device", "cpu", "--preset", "tiny",
                    "--dtype", "float32"])
    frames = video_io.read_video_frames(out / "clip.mp4")
    assert frames.shape == (9, 64, 96, 3)


def test_inference_cli_saves_i420_as_the_reference(tmp_path, monkeypatch):
    """The CLI builds its pipeline with output_i420 and saves the planar
    I420 frames as "i420", as scripts/inference.py does; the file decodes to
    what dove_tpu.io.video.save_video writes from the same array."""
    from dove_tpu.io import video as jvideo
    from dove_tpu_torch import inference
    from dove_tpu_torch.io import video as video_io

    built, saved = [], []
    load = inference.load_pipeline
    monkeypatch.setattr(inference, "load_pipeline", lambda a: built.append(load(a)) or built[-1])
    save = video_io.save_video

    def spy(video, path, fps=16, pixel_format=None):
        saved.append((video.copy(), pixel_format))
        return save(video, path, fps, pixel_format)

    monkeypatch.setattr(video_io, "save_video", spy)
    src = tmp_path / "in"
    src.mkdir()
    save(_clip(9, 16, 24, 7), src / "clip.mp4")
    out = tmp_path / "out"
    inference.main(["--input_dir", str(src), "--output_path", str(out),
                    "--is_vae_st", "--device", "cpu", "--preset", "tiny",
                    "--dtype", "float32"])
    (pipe,) = built
    assert pipe.output_i420
    (i420, pixel_format), = saved
    assert pixel_format == "i420"
    assert i420.dtype == np.uint8 and i420.shape == (9, 64 * 3 // 2, 96)
    ref_path = jvideo.save_video(i420, tmp_path / "ref.mp4", pixel_format="i420")
    ours = video_io.read_video_frames(out / "clip.mp4")
    ref = jvideo.read_video_frames(ref_path)
    assert ours.shape == (9, 64, 96, 3)
    np.testing.assert_array_equal(ours, ref)
