"""Parity of the PyTorch port's VAE (dove_tpu_torch.models.vae) with dove_tpu.

fp32 on the CPU, TF32 off. The clips are long enough that ``_frame_chunks``
makes two chunks on both sides, so the causal conv cache is threaded; the
causal padding and odd-first-frame rules are also held one primitive at a
time.
"""

from __future__ import annotations

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dove_tpu import config as jcfg
from dove_tpu.models import vae as jvae
from dove_tpu_torch import config as tcfg
from dove_tpu_torch import weights as tweights
from dove_tpu_torch.models import vae as tvae
from torch_threads import two_torch_threads  # noqa: F401 (autouse)

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

GOLDEN = Path(__file__).resolve().parent / "fixtures" / "golden" / "15"
ATOL = 1e-4  # fp32, different conv summation orders
PSNR_BAR_DB = 50.0  # the bar of tests/test_parity_golden.py


def psnr_db(ours: np.ndarray, ref: np.ndarray) -> float:
    """PSNR over the reference's value range (parity_check.compare's)."""
    ours, ref = np.asarray(ours, np.float64), np.asarray(ref, np.float64)
    span = float(ref.max() - ref.min()) or 1.0
    mse = float(np.mean((ours - ref) ** 2))
    return 200.0 if mse == 0 else 10.0 * np.log10(span**2 / mse)


@pytest.fixture(scope="module")
def tiny_vaes():
    cfg_j = jcfg.tiny_test()
    rng = np.random.default_rng(0)
    tree = jax.tree.map(np.asarray,
                        jvae.init_vae_params(jax.random.PRNGKey(1), cfg_j.vae))
    # move GroupNorm gains/biases off 1/0 so the affine path is exercised
    tree = jax.tree.map(
        lambda x: x + 0.05 * rng.standard_normal(x.shape).astype(np.float32), tree)
    vae = tweights.convert_vae(tweights.jax_vae_to_diffusers(tree),
                               tcfg.tiny_test().vae, torch.float32)
    return cfg_j, jax.tree.map(jnp.asarray, tree), vae


def test_frame_chunks_thread_the_cache():
    # the clip sizes below must really make two chunks
    assert len(tvae._frame_chunks(17, 8)) == 2
    assert len(tvae._frame_chunks(5, 2)) == 2
    for n, b in [(17, 8), (9, 8), (5, 2), (3, 2), (1, 2), (33, 16)]:
        assert tvae._frame_chunks(n, b) == jvae._frame_chunks(n, b)


def test_encode_moments_matches_jax(tiny_vaes):
    cfg_j, tree, vae = tiny_vaes
    video = np.random.default_rng(1).uniform(-1, 1, (1, 17, 32, 24, 3)).astype(np.float32)
    ref = jvae.encode_moments(cfg_j.vae, tree, jnp.asarray(video))
    with torch.no_grad():
        ours = tvae.encode_moments(tcfg.tiny_test().vae, vae, torch.from_numpy(video))
    assert ours.shape == ref.shape == (1, 5, 4, 3, 16)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=ATOL, rtol=0)


def test_decode_matches_jax(tiny_vaes):
    cfg_j, tree, vae = tiny_vaes
    latent = np.random.default_rng(2).standard_normal((1, 5, 4, 3, 8)).astype(np.float32)
    ref = jvae.decode(cfg_j.vae, tree, jnp.asarray(latent))
    with torch.no_grad():
        ours = tvae.decode(tcfg.tiny_test().vae, vae, torch.from_numpy(latent))
    assert ours.shape == ref.shape == (1, 17, 32, 24, 3)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=ATOL, rtol=0)


def test_sample_latent_mean_matches_jax():
    moments = np.random.default_rng(3).standard_normal((1, 3, 4, 4, 16)).astype(np.float32)
    ref = jvae.sample_latent(jnp.asarray(moments), None, 0.7)
    ours = tvae.sample_latent(torch.from_numpy(moments), None, 0.7)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=1e-6, rtol=0)


def _conv3d_pair(rng, kt, cin=3, cout=4):
    w = rng.standard_normal((kt, 3, 3, cin, cout)).astype(np.float32) * 0.3
    b = rng.standard_normal((cout,)).astype(np.float32)
    mod = tvae.CausalConv3d(cin, cout, (kt, 3, 3))
    with torch.no_grad():
        mod.conv.weight.copy_(torch.from_numpy(w.transpose(4, 3, 0, 1, 2).copy()))
        mod.conv.bias.copy_(torch.from_numpy(b))
    return {"kernel": jnp.asarray(w), "bias": jnp.asarray(b)}, mod


def _ncdhw(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(x).permute(0, 4, 1, 2, 3)


def _ndhwc(x: torch.Tensor) -> np.ndarray:
    return x.permute(0, 2, 3, 4, 1).numpy()


def test_causal_conv3d_first_frame_replicate_and_cache():
    """At a clip start the first frame is replicated k_t-1 times as left
    padding; a continuation takes the previous chunk's trailing frames."""
    rng = np.random.default_rng(4)
    p, mod = _conv3d_pair(rng, kt=3)
    x = rng.standard_normal((1, 5, 6, 5, 3)).astype(np.float32)
    ref0, cache0 = jvae.causal_conv3d(p, jnp.asarray(x[:, :3]), None)
    ref1, _ = jvae.causal_conv3d(p, jnp.asarray(x[:, 3:]), cache0)
    with torch.no_grad():
        ours0, tcache = tvae.causal_conv3d(mod, _ncdhw(x[:, :3]), None)
        ours1, _ = tvae.causal_conv3d(mod, _ncdhw(x[:, 3:]), tcache)
        whole, _ = tvae.causal_conv3d(mod, _ncdhw(x), None)
    np.testing.assert_allclose(_ndhwc(ours0), np.asarray(ref0), atol=1e-5)
    np.testing.assert_allclose(_ndhwc(ours1), np.asarray(ref1), atol=1e-5)
    np.testing.assert_allclose(_ndhwc(tcache), np.asarray(cache0), atol=0)
    # chunked == whole clip
    np.testing.assert_allclose(
        torch.cat([ours0, ours1], dim=2).numpy(), whole.numpy(), atol=1e-5)


@pytest.mark.parametrize("frames", [1, 2, 3, 5])
def test_downsample_odd_first_frame(frames):
    rng = np.random.default_rng(10 + frames)
    w = rng.standard_normal((3, 3, 4, 4)).astype(np.float32) * 0.3
    b = rng.standard_normal((4,)).astype(np.float32)
    mod = tvae.Conv2dHolder(4)
    with torch.no_grad():
        mod.conv.weight.copy_(torch.from_numpy(w.transpose(3, 2, 0, 1).copy()))
        mod.conv.bias.copy_(torch.from_numpy(b))
    x = rng.standard_normal((1, frames, 6, 6, 4)).astype(np.float32)
    ref = jvae._downsample({"conv": {"kernel": jnp.asarray(w), "bias": jnp.asarray(b)}},
                           jnp.asarray(x), True)
    with torch.no_grad():
        ours = tvae._downsample(mod, _ncdhw(x), True)
    assert _ndhwc(ours).shape == ref.shape
    np.testing.assert_allclose(_ndhwc(ours), np.asarray(ref), atol=1e-5)


@pytest.mark.parametrize("frames,first", [(1, True), (2, True), (3, True),
                                          (3, False), (1, False)])
def test_upsample_odd_first_frame(frames, first):
    rng = np.random.default_rng(20 + frames)
    w = rng.standard_normal((3, 3, 4, 4)).astype(np.float32) * 0.3
    b = rng.standard_normal((4,)).astype(np.float32)
    mod = tvae.Conv2dHolder(4)
    with torch.no_grad():
        mod.conv.weight.copy_(torch.from_numpy(w.transpose(3, 2, 0, 1).copy()))
        mod.conv.bias.copy_(torch.from_numpy(b))
    x = rng.standard_normal((1, frames, 3, 4, 4)).astype(np.float32)
    ref = jvae._upsample({"conv": {"kernel": jnp.asarray(w), "bias": jnp.asarray(b)}},
                         jnp.asarray(x), True, first)
    with torch.no_grad():
        ours = tvae._upsample(mod, _ncdhw(x), True, first)
    assert _ndhwc(ours).shape == ref.shape
    np.testing.assert_allclose(_ndhwc(ours), np.asarray(ref), atol=1e-5)


@pytest.fixture(scope="module")
def golden_vae():
    from safetensors import safe_open

    fx = np.load(GOLDEN / "golden.npz", allow_pickle=False)
    with safe_open(str(GOLDEN / "vae.safetensors"), framework="pt") as f:
        tensors = {k: f.get_tensor(k) for k in f.keys()}
    cfg = tcfg.tiny_test()
    return cfg, fx, tweights.convert_vae(tensors, cfg.vae, torch.float32)


def test_vae_golden_moments(golden_vae):
    cfg, fx, vae = golden_vae
    with torch.no_grad():
        out = tvae.encode_moments(cfg.vae, vae, torch.from_numpy(fx["input_video"]))
    assert out.shape == fx["vae_moments"].shape
    assert psnr_db(out.numpy(), fx["vae_moments"]) >= PSNR_BAR_DB


def test_vae_golden_decode(golden_vae):
    cfg, fx, vae = golden_vae
    with torch.no_grad():
        out = tvae.decode(cfg.vae, vae, torch.from_numpy(fx["input_latent"]))
    assert out.shape == fx["vae_decode_out"].shape
    assert psnr_db(out.numpy(), fx["vae_decode_out"]) >= PSNR_BAR_DB
