"""Parity of the PyTorch port's DiT (dove_tpu_torch.models.dit) with dove_tpu.

fp32 on the CPU. The JAX package's tiny_test() parameters go through
``from_jax_params``; the golden fixtures (1.5, and the 2B at its sample grid
and at a second geometry) go through ``convert_dit``, the path a released
checkpoint takes.
"""

from __future__ import annotations

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dove_tpu import config as jcfg
from dove_tpu.models import dit as jdit
from dove_tpu.models import vae as jvae
from dove_tpu_torch import config as tcfg
from dove_tpu_torch import weights as tweights

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

GOLDEN_ROOT = Path(__file__).resolve().parent / "fixtures" / "golden"
ATOL = 1e-4  # fp32, different summation orders through 2 blocks
PSNR_BAR_DB = 50.0  # the bar of tests/test_parity_golden.py


def psnr_db(ours: np.ndarray, ref: np.ndarray) -> float:
    """PSNR over the reference's value range (parity_check.compare's)."""
    ours, ref = np.asarray(ours, np.float64), np.asarray(ref, np.float64)
    span = float(ref.max() - ref.min()) or 1.0
    mse = float(np.mean((ours - ref) ** 2))
    return 200.0 if mse == 0 else 10.0 * np.log10(span**2 / mse)


def _perturbed(tree, seed: int):
    """Random params with LayerNorm gains and biases moved off 1 and 0, so
    the affine and bias paths are exercised."""
    leaves, treedef = jax.tree.flatten(tree)
    rng = np.random.default_rng(seed)
    leaves = [np.asarray(x) + 0.05 * rng.standard_normal(x.shape).astype(np.float32)
              for x in leaves]
    return jax.tree.unflatten(treedef, leaves)


@pytest.fixture(scope="module")
def tiny_models():
    cfg_j = jcfg.tiny_test()
    dit_tree = _perturbed(jdit.init_dit_params(jax.random.PRNGKey(0), cfg_j.dit), 1)
    vae_tree = jax.tree.map(np.asarray,
                            jvae.init_vae_params(jax.random.PRNGKey(1), cfg_j.vae))
    dit, _ = tweights.from_jax_params(tcfg.tiny_test(), dit_tree, vae_tree)
    return cfg_j, dit_tree, dit


@pytest.mark.parametrize("bounded", [False, True])
def test_dit_forward_matches_jax(tiny_models, bounded):
    cfg_j, dit_tree, dit = tiny_models
    rng = np.random.default_rng(2)
    latent = rng.standard_normal((1, 4, 8, 8, 8)).astype(np.float32)
    text = rng.standard_normal((1, 7, 32)).astype(np.float32)
    t = np.array([399], np.int32)

    ref = jdit.dit_forward(
        jax.tree.map(jnp.asarray, dit_tree), cfg_j.dit, jnp.asarray(latent),
        jnp.asarray(text), jnp.asarray(t), bounded_logits=bounded,
    )
    with torch.no_grad():
        ours = dit(torch.from_numpy(latent), torch.from_numpy(text),
                   torch.from_numpy(t), bounded_logits=bounded)
    assert ours.shape == ref.shape
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=ATOL, rtol=0)


def test_dit_flash_backend_matches_jax(tiny_models):
    """backend="flash" on the CPU is K1's plain version; it must agree with
    the JAX package's naive attention path at the DiT level too."""
    cfg_j, dit_tree, dit = tiny_models
    rng = np.random.default_rng(3)
    latent = rng.standard_normal((1, 2, 8, 4, 6)).astype(np.float32)
    text = rng.standard_normal((1, 7, 32)).astype(np.float32)
    t = np.array([250], np.int32)
    ref = jdit.dit_forward(
        jax.tree.map(jnp.asarray, dit_tree), cfg_j.dit, jnp.asarray(latent),
        jnp.asarray(text), jnp.asarray(t),
    )
    with torch.no_grad():
        ours = dit(torch.from_numpy(latent), torch.from_numpy(text),
                   torch.from_numpy(t), attention_backend="flash",
                   bounded_logits=True)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=ATOL, rtol=0)


def golden_config(variant: str) -> tcfg.PipelineConfig:
    """The port's config of a golden fixture: tests/test_parity_golden.py's
    ``_config`` (the 2B's latent-unit sample grid is the first geometry's)."""
    base = tcfg.tiny_test()
    if variant == "15":
        return base
    return tcfg.PipelineConfig(
        dit=tcfg.DiTConfig(
            num_layers=2, num_attention_heads=4, attention_head_dim=16,
            in_channels=8, out_channels=8, text_embed_dim=32,
            max_text_seq_length=7, time_embed_dim=16,
            patch_size_t=None, patch_bias=True,
            use_rotary_positional_embeddings=False,
            sample_height=8, sample_width=8, sample_frames=9,
        ),
        vae=base.vae,
        scheduler=tcfg.SchedulerConfig(snr_shift_scale=3.0),
    )


def golden_fixture(case: str) -> tuple[str, dict, Path]:
    """``"2b:g2"`` -> ("2b", the second geometry's arrays, the variant's
    directory); ``"15"``, ``"2b"`` -> the first geometry's."""
    variant, _, geom = case.partition(":")
    d = GOLDEN_ROOT / variant
    fx = np.load(d / ("golden_g2.npz" if geom else "golden.npz"), allow_pickle=False)
    return variant, dict(fx), d


@pytest.mark.parametrize("case", ["15", "2b", "2b:g2"])
def test_dit_golden_15(case):
    """The committed golden DiTs through convert_dit: CogVideoX1.5, and the
    2B at its sample grid (the stored sincos table over [text | video]) and
    at a second geometry (the table recomputed for its grid). The 2B's
    state dict has no ``pos_embedding`` (diffusers does not save it), so
    convert_dit builds it."""
    from safetensors import safe_open

    variant, fx, d = golden_fixture(case)
    with safe_open(str(d / "transformer.safetensors"), framework="pt") as f:
        tensors = {k: f.get_tensor(k) for k in f.keys()}
    cfg = golden_config(variant)
    assert "patch_embed.pos_embedding" not in tensors
    dit = tweights.convert_dit(tensors, cfg.dit, torch.float32)
    with torch.no_grad():
        out = dit(
            torch.from_numpy(fx["dit_latent"]),
            torch.from_numpy(fx["text_embeds"]),
            torch.tensor([int(fx["timestep"])]),
        )
    assert out.shape == fx["dit_out"].shape
    assert psnr_db(out.numpy(), fx["dit_out"]) >= PSNR_BAR_DB
