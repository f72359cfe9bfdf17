"""The CogVideoX-2B family in the PyTorch port against dove_tpu, on the CPU.

fp32, tiny widths. The 2B differs from the 1.5-5B in its patch embedding (a
stride-2 conv2d per frame, no temporal patching), its positions (fixed 3D
sincos: the stored table at the config's sample grid over [text | video], a
table recomputed for any other grid over the video tokens) and its final
norm (the video tokens alone); no RoPE.

* The committed 2B goldens (``tests/fixtures/golden/2b``, both geometries)
  through ``convert_dit`` / ``convert_vae``: every module that
  tests/test_parity_golden.py checks, at its 50 dB bar (``dit_out`` is
  ``tests/test_torch_dit.py::test_dit_golden_15``'s).
* The JAX package live, on tests/test_parity_golden.py's 2B config with
  perturbed weights carried across by ``from_jax_params``: the DiT forward
  (bounded and online) at the sample grid and at another, at atol 1e-4;
  the staged, streamed and fused clips, the posterior mean on both sides,
  within one LSB of uint8 output (the fused path's float frames: 1e-4); a stage-1 loss with its LoRA gradients
  and a stage-2 loss (pixel and frame-difference terms through the decode
  with gradients) with its LoRA gradients, loss rtol 1e-5, gradients 1e-4
  of each leaf's largest.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dove_tpu import config as jcfg
from dove_tpu.models import dit as jdit
from dove_tpu.models import vae as jvae
from dove_tpu.ops.scheduler import Schedule as JSchedule
from dove_tpu.pipeline import DovePipeline as JPipeline
from dove_tpu.train import lora as jlora
from dove_tpu.train import losses as jlosses
from dove_tpu_torch import weights as tweights
from dove_tpu_torch.models import vae as tvae
from dove_tpu_torch.ops.scheduler import Schedule
from dove_tpu_torch.pipeline import DovePipeline
from dove_tpu_torch.train import lora as tlora
from dove_tpu_torch.train import losses as tlosses
from test_torch_dit import PSNR_BAR_DB, golden_config, golden_fixture, psnr_db

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

ATOL = 1e-4  # fp32, different summation orders through 2 blocks
FUSED_ATOL = 1e-4  # float frames; measured 6.1e-6
RANK, ALPHA = 4, 2
SCALE = ALPHA / RANK
LOSS_RTOL = 1e-5
GRAD_TOL = 1e-4  # max |dgrad| relative to the largest gradient of the leaf


# ---------------------------------------------------------------------------
# The committed goldens
# ---------------------------------------------------------------------------

def _golden_cases() -> list[tuple[str, str]]:
    """(fixture, module) for every module of tests/test_parity_golden.py
    that a 2B fixture holds, dit_out aside."""
    modules = ("vae_moments", "vae_decode_out", "dit_block0_out",
               "dit_blocklast_out", "sched_alphas", "sched_x0")
    cases = []
    for case in ("2b", "2b:g2"):
        held = golden_fixture(case)[1]
        cases += [(case, m) for m in modules if m in held]
    return cases


_OUTS: dict[str, dict[str, np.ndarray]] = {}


def _port_outputs(case: str) -> tuple[dict, dict[str, np.ndarray]]:
    """The port's value of each golden module: scripts/parity_check.py's
    ``jax_outputs`` step for step (block taps through the first and through
    every block, with the positions the forward adds)."""
    from safetensors import safe_open

    variant, fx, d = golden_fixture(case)
    if case in _OUTS:
        return fx, _OUTS[case]
    cfg = golden_config(variant)
    tensors = {}
    for sub in ("transformer", "vae"):
        with safe_open(str(d / f"{sub}.safetensors"), framework="pt") as f:
            tensors[sub] = {k: f.get_tensor(k) for k in f.keys()}
    dit = tweights.convert_dit(tensors["transformer"], cfg.dit, torch.float32)
    vae = tweights.convert_vae(tensors["vae"], cfg.vae, torch.float32)
    z = torch.from_numpy(fx["dit_latent"])
    text = torch.from_numpy(fx["text_embeds"])
    t = torch.tensor([int(fx["timestep"])])
    out = {}
    with torch.no_grad():
        out["vae_moments"] = tvae.encode_moments(
            cfg.vae, vae, torch.from_numpy(fx["input_video"])).numpy()
        out["vae_decode_out"] = tvae.decode(
            cfg.vae, vae, torch.from_numpy(fx["input_latent"])).numpy()
        hidden, encoder, temb, rope = dit.embed(z, text, t)
        for i, block in enumerate(dit.transformer_blocks):
            hidden, encoder = block(hidden, encoder, temb, rope, None, False)
            if i == 0:
                out["dit_block0_out"] = hidden.numpy()
        out["dit_blocklast_out"] = hidden.numpy()
        v = dit(z, text, t)
    sched = Schedule.create(cfg.scheduler)
    out["sched_alphas"] = sched.alphas_cumprod.numpy()
    out["sched_x0"] = sched.velocity_to_x0(v, z, t).numpy()
    _OUTS[case] = out
    return fx, out


@pytest.mark.parametrize("case,module", _golden_cases())
def test_2b_golden_modules(case, module):
    fx, out = _port_outputs(case)
    assert out[module].shape == fx[module].shape
    assert psnr_db(out[module], fx[module]) >= PSNR_BAR_DB


def test_2b_pos_embedding_built_as_jax_builds_it():
    """The table convert_dit builds for a state dict without one is the one
    the JAX package's init builds, and the DiT keeps one recomputed table
    per grid."""
    cfg_t = golden_config("2b")
    tree = jax.tree.map(np.asarray,
                        jdit.init_dit_params(jax.random.PRNGKey(0), _jax_config().dit))
    sd = tweights.jax_dit_to_diffusers(tree)
    want = sd.pop("patch_embed.pos_embedding")
    dit = tweights.convert_dit(sd, cfg_t.dit, torch.float32)
    got = dit.patch_embed.pos_embedding.numpy()
    assert got.shape == want.shape == (1, 7 + 3 * 4 * 4, 64)
    np.testing.assert_allclose(got, want, atol=1e-7, rtol=0)
    assert not got[:, :7].any()
    x = torch.zeros(1, 5, 8, 8, 12)
    with torch.no_grad():
        for _ in range(2):
            dit(x, torch.zeros(1, 7, 32), torch.tensor([399]))
    assert list(dit._pos_cache) == [((5, 4, 6), torch.float32, x.device)]


# ---------------------------------------------------------------------------
# The JAX package live
# ---------------------------------------------------------------------------

def _jax_config() -> jcfg.PipelineConfig:
    """tests/test_parity_golden.py's 2B config."""
    base = jcfg.tiny_test()
    return jcfg.PipelineConfig(
        dit=jcfg.DiTConfig(
            num_layers=2, num_attention_heads=4, attention_head_dim=16,
            in_channels=8, out_channels=8, text_embed_dim=32,
            max_text_seq_length=7, time_embed_dim=16,
            patch_size_t=None, patch_bias=True,
            use_rotary_positional_embeddings=False,
            sample_height=8, sample_width=8, sample_frames=9,
        ),
        vae=base.vae,
        scheduler=jcfg.SchedulerConfig(snr_shift_scale=3.0),
    )


def _perturbed(tree, seed: int, scale: float = 0.05):
    leaves, treedef = jax.tree.flatten(tree)
    rng = np.random.default_rng(seed)
    leaves = [np.asarray(x) + scale * rng.standard_normal(x.shape).astype(np.float32)
              for x in leaves]
    return jax.tree.unflatten(treedef, leaves)


@pytest.fixture(scope="module")
def models():
    cfg_j = _jax_config()
    dit_tree = _perturbed(jdit.init_dit_params(jax.random.PRNGKey(0), cfg_j.dit), 1)
    vae_tree = jax.tree.map(np.asarray,
                            jvae.init_vae_params(jax.random.PRNGKey(1), cfg_j.vae))
    dit, vae = tweights.from_jax_params(golden_config("2b"), dit_tree, vae_tree)
    prompt = np.random.default_rng(0).standard_normal((7, 32)).astype(np.float32)
    return cfg_j, dit_tree, vae_tree, dit, vae, prompt


# (latent frames, h, w): the sample grid (3, 8, 8 tokens: the stored table)
# and an odd one (the recomputed table)
GRIDS = {"sample_grid": (3, 16, 16), "other_grid": (5, 8, 12)}


@pytest.mark.parametrize("grid", list(GRIDS))
@pytest.mark.parametrize("bounded", [False, True])
def test_dit_2b_forward_matches_jax(models, bounded, grid):
    cfg_j, dit_tree, _, dit, _, _ = models
    f, h, w = GRIDS[grid]
    rng = np.random.default_rng(2)
    latent = rng.standard_normal((1, f, 8, h, w)).astype(np.float32)
    text = rng.standard_normal((1, 7, 32)).astype(np.float32)
    t = np.array([399], np.int32)
    ref = jdit.dit_forward(
        jax.tree.map(jnp.asarray, dit_tree), cfg_j.dit, jnp.asarray(latent),
        jnp.asarray(text), jnp.asarray(t), bounded_logits=bounded)
    with torch.no_grad():
        ours = dit(torch.from_numpy(latent), torch.from_numpy(text),
                   torch.from_numpy(t), bounded_logits=bounded,
                   attention_backend="flash" if bounded else None)
    assert ours.shape == ref.shape
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=ATOL, rtol=0)


def _pipes(models, **flags):
    cfg_j, dit_tree, vae_tree, dit, vae, prompt = models
    jp = JPipeline(
        config=cfg_j, dit_params=jax.tree.map(jnp.asarray, dit_tree),
        vae_params=jax.tree.map(jnp.asarray, vae_tree),
        prompt_embedding=jnp.asarray(prompt), dtype=jnp.float32,
        sample_posterior=False, donate_weights=False, output_uint8=True, **flags)
    tp = DovePipeline(
        config=golden_config("2b"), dit=dit, vae=vae,
        prompt_embedding=torch.from_numpy(prompt), dtype=torch.float32,
        device="cpu", sample_posterior=False, output_uint8=True, **flags)
    return jp, tp


# path -> (pipeline flags, frames, h, w): the staged path on 9 frames (3
# latents, no temporal padding), the streamed one on 41 odd-sized frames (a
# 33- and an 8-frame segment), the fused outer-tile path untiled
CLIPS = {
    "staged": (dict(vae_tiling=True), 9, 16, 16),
    "streamed": (dict(vae_tiling=True, streaming="on"), 41, 14, 18),
    "fused": (dict(vae_tiling=False), 9, 16, 16),
}


@pytest.mark.parametrize("path", list(CLIPS))
def test_2b_clip_matches_jax(models, path):
    flags, n, h, w = CLIPS[path]
    jp, tp = _pipes(models, **flags)
    frames = np.random.default_rng(3).uniform(0, 1, (n, h, w, 3)).astype(np.float32)
    ref = jp.process_frames(frames, seed=0)
    ours = tp.process_frames(frames, seed=0)
    assert ours.shape == ref.shape == (n, 4 * h, 4 * w, 3)
    assert ours.dtype == ref.dtype
    if path == "fused":  # float frames in [0, 1]
        np.testing.assert_allclose(ours, ref, atol=FUSED_ATOL, rtol=0)
    else:
        assert ours.dtype == np.uint8
        assert np.abs(ours.astype(int) - ref.astype(int)).max() <= 1


def _lora_tree(cfg_dit, seed: int) -> dict:
    """The JAX package's LoRA init with B moved off zero, so that dA != 0."""
    tree = jax.tree.map(np.asarray, jlora.init_lora_params(
        jax.random.PRNGKey(seed), cfg_dit, rank=RANK))
    rng = np.random.default_rng(seed)
    for ab in tree.values():
        ab["B"] = 0.05 * rng.standard_normal(ab["B"].shape).astype(np.float32)
    return tree


def _max_rel(ours: np.ndarray, ref: np.ndarray) -> float:
    return float(np.abs(ours - ref).max() / max(np.abs(ref).max(), 1e-30))


@pytest.mark.parametrize("stage", [1, 2])
def test_2b_training_loss_and_lora_grads_match_jax(models, stage):
    """Stage 1 (latent MSE, 3 latent frames: no temporal padding for the 2B)
    through the flash backend's plain versions, and stage 2 (per-frame
    decode with gradients, pixel and frame-difference terms) with
    checkpointing, against jax.value_and_grad."""
    cfg_j, dit_tree, vae_tree, dit, vae, _ = models
    tree = _lora_tree(cfg_j.dit, seed=4)
    rng = np.random.default_rng(5)
    if stage == 1:
        batch = {"lq_latent": rng.standard_normal((2, 3, 8, 6, 8)).astype(np.float32),
                 "hq_latent": rng.standard_normal((2, 3, 8, 6, 8)).astype(np.float32)}
        kw_j, kw_t = dict(attention_backend="flash"), dict(attention_backend="flash")
    else:
        batch = {"lq_latent": rng.standard_normal((1, 2, 4, 4, 8)).astype(np.float32),
                 "hq_video": rng.uniform(-1, 1, (1, 2, 32, 32, 3)).astype(np.float32)}
        kw_j, kw_t = dict(remat=True), dict(gradient_checkpointing=True)
    batch["prompt_embeds"] = rng.standard_normal(
        (batch["lq_latent"].shape[0], 7, 32)).astype(np.float32)
    sched_j = JSchedule.create(cfg_j.scheduler)
    params_j = jax.tree.map(jnp.asarray, dit_tree)
    batch_j = jax.tree.map(jnp.asarray, batch)

    def loss_j(lora):
        eff = jlora.apply_lora(params_j, lora, SCALE)
        if stage == 1:
            return jlosses.stage1_loss(cfg_j, sched_j, eff, batch_j, None, **kw_j)
        return jlosses.stage2_loss(cfg_j, sched_j, eff,
                                   jax.tree.map(jnp.asarray, vae_tree), batch_j,
                                   None, **kw_j)

    (ref_loss, ref_aux), ref_grads = jax.jit(jax.value_and_grad(loss_j, has_aux=True))(
        jax.tree.map(jnp.asarray, tree))

    cfg_t = golden_config("2b")
    lora_t = tweights.from_jax_lora(tree)
    batch_t = {k: torch.from_numpy(v) for k, v in batch.items()}
    sched = Schedule.create(cfg_t.scheduler)
    if stage == 1:
        loss, aux = tlosses.stage1_loss(cfg_t, sched, dit, batch_t, lora=lora_t,
                                        lora_scale=SCALE, **kw_t)
    else:
        loss, aux = tlosses.stage2_loss(cfg_t, sched, dit, vae, batch_t, lora=lora_t,
                                        lora_scale=SCALE, **kw_t)
    loss.backward()
    assert set(aux) == set(ref_aux)
    for k in aux:
        np.testing.assert_allclose(float(aux[k].detach()), float(ref_aux[k]),
                                   rtol=LOSS_RTOL, err_msg=k)
    np.testing.assert_allclose(float(loss.detach()), float(ref_loss), rtol=LOSS_RTOL)
    for t in tlora.TARGETS:
        for ab in ("A", "B"):
            ref = np.asarray(ref_grads[t][ab])
            assert np.abs(ref).max() > 0
            assert _max_rel(lora_t[t][ab].grad.numpy(), ref) <= GRAD_TOL, (t, ab)


def test_2b_preset_is_the_jax_packages():
    """The port's cogvideox_2b() preset is the JAX package's, field for field."""
    from dove_tpu_torch import config as tcfg

    ours, ref = tcfg.cogvideox_2b(), jcfg.cogvideox_2b()
    for part in ("dit", "vae", "scheduler"):
        assert dataclasses.asdict(getattr(ours, part)) == dataclasses.asdict(
            getattr(ref, part)), part


@pytest.mark.parametrize("family", ["gaussian", "outlier"])
def test_2b_synthesis_draws_its_3d_leaves_as_the_jax_script(family):
    """int8_drift_report.realistic_params on the 2B: the JAX script draws
    every leaf of more than one dim like a kernel, the 3-D ``pos_embedding``
    [1, L, dim] too (fan-in L, outlier gains on dim), and the patch conv
    [p, p, C, dim] (fan-in p * p * C); the port's draws have the JAX draws'
    shapes in the JAX tree and their scales (10%)."""
    from dove_tpu_torch import int8_drift_report as tdrift
    from test_torch_drift_report import jdrift

    cfg_j = _jax_config()
    shapes = jax.eval_shape(lambda k: jdit.init_dit_params(k, cfg_j.dit, jnp.float32),
                            jax.random.PRNGKey(0))
    ref = tweights.jax_dit_to_diffusers(jax.tree.map(
        np.asarray, jdrift.realistic_params(shapes, seed=1, dtype=jnp.float32,
                                            family=family)))
    dit, _ = tdrift.empty_models(golden_config("2b"), torch.float32, torch.device("cpu"))
    tdrift.realistic_params(dit, seed=1, family=family)
    ours = dit.state_dict()
    L = 7 + 3 * 4 * 4
    for name, fan_in in (("patch_embed.pos_embedding", L),
                         ("patch_embed.proj.weight", 2 * 2 * 8)):
        a, b = ours[name].numpy(), ref[name]
        assert a.shape == b.shape
        assert tdrift.jax_shape(ours[name].shape, False, 2, name) == (
            (1, L, 64) if "pos" in name else (2, 2, 8, 64))
        for x in (a, b):
            assert abs(x.std() * fan_in ** 0.5 - 1.0) <= 0.1, (name, x.std())
    if family == "outlier":  # the gains on the table's last axis (dim)
        a = ours["patch_embed.pos_embedding"].numpy()[0]
        assert np.log(np.sqrt((a * a).mean(0))).std() > 0.3
        assert np.log(np.sqrt((a * a).mean(1))).std() < 0.3
