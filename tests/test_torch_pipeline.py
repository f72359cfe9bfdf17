"""Parity of the PyTorch port's staged pipeline with dove_tpu's (fp32, CPU).

A 9-frame 64x64 LQ clip makes a 256x256 output and a 32x32 latent, so the
decode stage plans 2x2 windows and the feathered assembly runs. Both sides
take the posterior mean (the two frameworks' RNGs cannot match) and the same
tiny_test() weights. Stage outputs before uint8 quantization are held at
atol 1e-4; quantized outputs within one LSB, since a 1e-6 difference can
move a value across a rounding boundary.
"""

from __future__ import annotations

import dataclasses
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
    assert set(tp.stage_times) == {"enc", "dit", "dec"}


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
    _, tp = _pipes(models)
    frames = _clip(1, 16, 16, 4)
    with pytest.raises(NotImplementedError):
        tp.process_frames(frames, tile_size_hw=(64, 64))
    with pytest.raises(NotImplementedError):
        tp.process_frames(frames, mesh=object())
    with pytest.raises(NotImplementedError):
        dataclasses.replace(tp, quantize="int8")
    with pytest.raises(NotImplementedError):  # the fused tile path
        dataclasses.replace(tp, vae_tiling=False).process_frames(frames)


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
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m.removesuffix('.__init__'))\n"
        "import chip_smoke\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'dove_tpu' or m.startswith('dove_tpu.')]\n"
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
