"""Stage-2 training in the PyTorch port against dove_tpu, on tiny_test().

fp32 on the CPU, one process, the same numbers in both packages: the DiT and
VAE trees (JAX's seeded init, carried across by ``weights.from_jax_params``),
the LoRA tree, a perceptual weight file this test writes from JAX's seeded
VGG16 (read by both packages' loaders), and seeded numpy batches of 2 frames
of 32 x 32. ``noise_step`` is 0 and the posterior is taken at its mean, so
no random draw has to match. Checked: ``stage2_loss`` and its DiT gradients
(LoRA and SFT, with and without checkpointing), the image/video coin flip,
two ``DOVES2Trainer`` steps against the JAX trainer's, the perceptual
choice and its opt-in error, and that a decode with gradients refuses the
convolutions that have no backward (K4, K5).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dove_tpu import config as jcfg
from dove_tpu.eval import vgg as jvgg
from dove_tpu.models import dit as jdit
from dove_tpu.models import vae as jvae
from dove_tpu.ops.scheduler import Schedule as JSchedule
from dove_tpu.train import args as jargs
from dove_tpu.train import lora as jlora
from dove_tpu.train import losses as jlosses
from dove_tpu.train import trainer as jtrainer
from dove_tpu_torch import config as tcfg
from dove_tpu_torch import weights as tweights
from dove_tpu_torch.models import vae as tvae
from dove_tpu_torch.ops import quant
from dove_tpu_torch.ops.scheduler import Schedule
from dove_tpu_torch.train import args as targs
from dove_tpu_torch.train import lora as tlora
from dove_tpu_torch.train import losses as tlosses
from dove_tpu_torch.train import trainer as ttrainer
from torch_threads import two_torch_threads  # noqa: F401 (autouse)

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

RANK, ALPHA = 4, 2
SCALE = ALPHA / RANK
LOSS_RTOL = 1e-5  # fp32, different summation orders (tests/test_torch_train.py)
GRAD_TOL = 1e-4  # max |dgrad| relative to the largest gradient of the leaf
F, S = 2, 32  # frames of S x S pixels: 4 x 4 latents


def _max_rel(ours: np.ndarray, ref: np.ndarray) -> float:
    return float(np.abs(ours - ref).max() / max(np.abs(ref).max(), 1e-30))


def _perturbed(tree, seed: int, scale: float = 0.05):
    leaves, treedef = jax.tree.flatten(tree)
    rng = np.random.default_rng(seed)
    leaves = [np.asarray(x) + scale * rng.standard_normal(x.shape).astype(np.float32)
              for x in leaves]
    return jax.tree.unflatten(treedef, leaves)


def _lora_tree(cfg_dit, seed: int) -> dict:
    """The JAX package's LoRA init with B moved off zero, so that dA != 0."""
    tree = jax.tree.map(np.asarray, jlora.init_lora_params(
        jax.random.PRNGKey(seed), cfg_dit, rank=RANK))
    rng = np.random.default_rng(seed)
    for ab in tree.values():
        ab["B"] = 0.05 * rng.standard_normal(ab["B"].shape).astype(np.float32)
    return tree


def _dists_file(path) -> str:
    """JAX's init_vgg16(PRNGKey(0)) with seeded biases and DISTS heads, as a
    torch state dict in torchvision's ``features.*`` layout."""
    params = jax.tree.map(np.asarray, jvgg.init_vgg16(jax.random.PRNGKey(0)))
    rng = np.random.default_rng(20)
    idx = (0, 2, 5, 7, 10, 12, 14, 17, 19, 21, 24, 26, 28)
    sd = {}
    for i, conv in zip(idx, [c for stage in params for c in stage]):
        sd[f"features.{i}.weight"] = torch.from_numpy(np.ascontiguousarray(
            np.transpose(conv["kernel"], (3, 2, 0, 1))))
        sd[f"features.{i}.bias"] = torch.from_numpy(
            0.05 * rng.standard_normal(conv["bias"].shape).astype(np.float32))
    for k in ("alpha", "beta"):
        sd[k] = torch.from_numpy(rng.uniform(0.1, 1, (1, 1475, 1, 1)).astype(np.float32))
    torch.save(sd, path)
    return str(path)


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    cfg_j = jcfg.tiny_test()
    dit_tree = _perturbed(jdit.init_dit_params(jax.random.PRNGKey(0), cfg_j.dit), 1)
    vae_tree = jax.tree.map(np.asarray,
                            jvae.init_vae_params(jax.random.PRNGKey(1), cfg_j.vae))
    dit, vae = tweights.from_jax_params(tcfg.tiny_test(), dit_tree, vae_tree)
    wpath = _dists_file(tmp_path_factory.mktemp("perceptual") / "dists.pt")
    return cfg_j, dit_tree, vae_tree, dit, vae, wpath


def _loss_batch(seed: int, frames: int = F) -> dict[str, np.ndarray]:
    rng = np.random.default_rng(seed)
    return {
        "lq_latent": rng.standard_normal((1, frames, S // 8, S // 8, 8)).astype(np.float32),
        "hq_video": rng.uniform(-1, 1, (1, frames, S, S, 3)).astype(np.float32),
        "prompt_embeds": rng.standard_normal((1, 7, 32)).astype(np.float32),
    }


# ---------------------------------------------------------------------------
# stage2_loss
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("training_type", ["lora", "sft"])
@pytest.mark.parametrize("remat", [False, True])
def test_stage2_loss_and_dit_grads_match_jax(models, training_type, remat):
    """Loss, its terms and the gradients of the trainable tensors (the LoRA
    tree, or every DiT parameter under SFT) against jax.value_and_grad,
    through the per-frame decode, DISTS on both packages' reading of one
    weight file, and the frame-difference term."""
    cfg_j, dit_tree, vae_tree, dit, vae, wpath = models
    batch = _loss_batch(3)
    tree = _lora_tree(cfg_j.dit, seed=4)
    sched_j = JSchedule.create(cfg_j.scheduler)
    params_j = jax.tree.map(jnp.asarray, dit_tree)
    jfn = jlosses.make_perceptual_fn("dists", weights_path=wpath)

    def loss_j(p):
        eff = jlora.apply_lora(params_j, p, SCALE) if training_type == "lora" else p
        return jlosses.stage2_loss(
            cfg_j, sched_j, eff, jax.tree.map(jnp.asarray, vae_tree),
            jax.tree.map(jnp.asarray, batch), None, perceptual_fn=jfn, remat=remat)

    trainable_j = jax.tree.map(jnp.asarray, tree if training_type == "lora" else dit_tree)
    (ref_loss, ref_aux), ref_grads = jax.jit(jax.value_and_grad(loss_j, has_aux=True))(
        trainable_j)

    cfg_t = tcfg.tiny_test()
    kw = dict(gradient_checkpointing=remat)
    if training_type == "lora":
        lora_t = tweights.from_jax_lora(tree)
        kw.update(lora=lora_t, lora_scale=SCALE)
        params = [lora_t[t][ab] for t in tlora.TARGETS for ab in ("A", "B")]
        refs = [np.asarray(ref_grads[t][ab]) for t in tlora.TARGETS for ab in ("A", "B")]
    else:
        dit.requires_grad_(True)
        ref_sd = tweights.jax_dit_to_diffusers(jax.tree.map(np.asarray, ref_grads))
        names, params = zip(*dit.named_parameters())
        refs = [ref_sd[n] for n in names]
    try:
        loss, aux = tlosses.stage2_loss(
            cfg_t, Schedule.create(cfg_t.scheduler), dit, vae,
            {k: torch.from_numpy(v) for k, v in batch.items()},
            perceptual_fn=tlosses.make_perceptual_fn("dists", weights_path=wpath), **kw)
        grads = torch.autograd.grad(loss, params)
    finally:
        dit.requires_grad_(False)
    assert set(aux) == set(ref_aux) == {"loss", "loss_pixel", "loss_perceptual",
                                        "loss_frame_diff"}
    for k in aux:
        np.testing.assert_allclose(float(aux[k]), float(ref_aux[k]), rtol=LOSS_RTOL)
    np.testing.assert_allclose(float(loss), float(ref_loss), rtol=LOSS_RTOL)
    assert not any(p.grad is not None for p in vae.parameters())
    for g, ref in zip(grads, refs):
        assert _max_rel(g.numpy(), ref) <= GRAD_TOL
    assert sum(float(g.abs().max()) > 0 for g in grads) >= len(grads) // 2


def test_image_loss_decodes_one_frame_and_skips_frame_diff(models):
    """An image step's one latent is padded to patch_size_t by repeating it
    and the copy is stripped: one frame decodes, and the frame-difference
    term is absent in both packages."""
    cfg_j, dit_tree, vae_tree, dit, vae, _ = models
    batch = _loss_batch(5, frames=1)
    ref_loss, ref_aux = jax.jit(lambda d, v, b: jlosses.stage2_loss(
        cfg_j, JSchedule.create(cfg_j.scheduler), d, v, b, None))(
        *(jax.tree.map(jnp.asarray, t) for t in (dit_tree, vae_tree, batch)))
    cfg_t = tcfg.tiny_test()
    loss, aux = tlosses.stage2_loss(cfg_t, Schedule.create(cfg_t.scheduler), dit, vae,
                                    {k: torch.from_numpy(v) for k, v in batch.items()})
    assert set(aux) == set(ref_aux) == {"loss", "loss_pixel"}
    np.testing.assert_allclose(float(loss), float(ref_loss), rtol=LOSS_RTOL)


# ---------------------------------------------------------------------------
# The decode with gradients
# ---------------------------------------------------------------------------

def test_remat_decode_equals_plain_decode(models):
    """The checkpointed decode gives the plain decode's pixels, gradients and
    conv cache; the cache holds the forward's tensors only."""
    *_, vae, _ = models
    cfg = tcfg.tiny_test().vae
    z = torch.from_numpy(np.random.default_rng(6).standard_normal(
        (2, 3, 4, 4, 8)).astype(np.float32))
    cot = torch.from_numpy(np.random.default_rng(7).standard_normal(
        (2, 9, 32, 32, 3)).astype(np.float32))
    out = {}
    for remat in (False, True):
        zz = z.clone().requires_grad_()
        px, cache = tvae.decode_cached(cfg, vae, zz, None, remat=remat)
        (g,) = torch.autograd.grad(px, zz, cot)
        out[remat] = (px.detach(), g, cache)
    (p0, g0, c0), (p1, g1, c1) = out[False], out[True]
    assert p0.shape == (2, 9, 32, 32, 3)
    torch.testing.assert_close(p1, p0, rtol=0, atol=1e-6)
    torch.testing.assert_close(g1, g0, rtol=0, atol=1e-6)
    assert set(c1) == set(c0) and len(c0) > 0
    for k in c0:
        if c0[k] is None:
            assert c1[k] is None
        else:
            torch.testing.assert_close(c1[k].detach(), c0[k].detach(), rtol=0, atol=1e-6)


def _wide_vae():
    cfg = tcfg.VAEConfig(latent_channels=8, block_out_channels=(128, 128),
                         layers_per_block=1, norm_num_groups=4,
                         sample_frames_batch_size=8, latent_frames_batch_size=2)
    return cfg, tvae.init_vae_params(cfg, seed=3)


def test_decode_with_gradients_refuses_k4_and_k5():
    """K4 and K5 have no backward: a decode under autograd through either
    raises (it does not fall back to another conv); without a gradient
    both routes run."""
    cfg, vae = _wide_vae()
    z = torch.from_numpy(np.random.default_rng(8).standard_normal(
        (1, 1, 2, 2, 8)).astype(np.float32))
    tvae.set_pallas_conv(True)
    try:
        with pytest.raises(RuntimeError, match="K5.*no backward"):
            tvae.decode(cfg, vae, z.clone().requires_grad_())
        with torch.no_grad():
            assert tvae.decode(cfg, vae, z).shape == (1, 1, 4, 4, 3)
    finally:
        tvae.set_pallas_conv(False)
    quant.quantize_vae(vae, "decoder")
    assert any(isinstance(m, quant.QConv3d) for m in vae.decoder.modules())
    with pytest.raises(RuntimeError, match="K4.*no backward"):
        tvae.decode(cfg, vae, z.clone().requires_grad_(), remat=True)
    with torch.no_grad():
        assert torch.isfinite(tvae.decode(cfg, vae, z)).all()


# ---------------------------------------------------------------------------
# The trainer
# ---------------------------------------------------------------------------

def _args(mod, tmp_path, **over):
    kw = dict(
        model_path=tmp_path / "nonexistent_model", model_name="dove-s2",
        base_preset="tiny", training_type="lora", rank=RANK, lora_alpha=ALPHA,
        output_dir=tmp_path / "out", data_root=tmp_path,
        train_resolution=(F, S, S), batch_size=1, train_steps=2,
        checkpointing_steps=100, mixed_precision="no", num_workers=0,
        learning_rate=1e-3, lr_warmup_steps=0, lr_scheduler="constant",
        max_grad_norm=1e-4, stastic_frequency=0, image_ratio=0.5,
        dists_weight=1.0, frame_diff_weight=1.0,
    )
    kw.update(over)
    return mod.Args(**kw)


def _flip(seed: int, step: int, ratio: float) -> bool:
    return bool(np.random.default_rng((seed, step)).uniform() < ratio)


def _recorded_choices(monkeypatch, tmp_path, seed: int, ratio: float, steps: int):
    """Which steps each package's stage-2 step takes as image steps: the
    stage-independent part of the step is replaced by a recorder of the
    batch it is handed."""
    batch = {k: np.full((1, 1, 2, 2, 3), i, np.float32)
             for i, k in enumerate(("hq_video", "lq_video", "hq_image", "lq_image"))}
    batch["prompt_embeds"] = np.zeros((1, 7, 32), np.float32)
    seen_j, seen_t = [], []
    monkeypatch.setattr(jtrainer.Trainer, "build_train_step",
                        lambda self: lambda *a: seen_j.append(a[3]))
    monkeypatch.setattr(ttrainer.Trainer, "train_step",
                        lambda self, b: seen_t.append(b))
    tj = jtrainer.DOVES2Trainer(_args(jargs, tmp_path / "j", seed=seed, image_ratio=ratio))
    step_j = tj.build_train_step()
    tt = ttrainer.DOVES2Trainer(_args(targs, tmp_path / "t", seed=seed, image_ratio=ratio),
                                device="cpu")
    for step in range(steps):
        tj.global_step = tt.global_step = step
        step_j(None, None, None, batch, None)
        tt.train_step({k: torch.from_numpy(v) for k, v in batch.items()})
    image_j = [float(b["hq_video"][0, 0, 0, 0, 0]) == 2 for b in seen_j]
    image_t = [float(b["hq_video"][0, 0, 0, 0, 0]) == 2 for b in seen_t]
    for b in seen_j + seen_t:  # the keys both packages keep
        assert set(b) == {"hq_video", "lq_video", "prompt_embeds"}
        assert float(b["lq_video"][0, 0, 0, 0, 0]) == float(b["hq_video"][0, 0, 0, 0, 0]) + 1
    return image_j, image_t


@pytest.mark.parametrize("seed,ratio", [(0, 0.8), (7, 0.5), (None, 0.2)])
def test_image_video_coin_matches_jax(monkeypatch, tmp_path, seed, ratio):
    image_j, image_t = _recorded_choices(monkeypatch, tmp_path, seed, ratio, steps=50)
    assert image_t == image_j
    assert 0 < sum(image_t) < 50
    assert image_t == [_flip(seed or 0, s, ratio) for s in range(50)]


def _sample_mean(monkeypatch):
    """Both packages' posterior sampling replaced by its mean."""
    j_sample, t_sample = jvae.sample_latent, ttrainer.sample_latent
    monkeypatch.setattr(jvae, "sample_latent", lambda m, rng, sf: j_sample(m, None, sf))
    monkeypatch.setattr(ttrainer, "sample_latent", lambda m, gen, sf: t_sample(m, None, sf))


def _pixel_batch(seed: int) -> dict[str, np.ndarray]:
    rng = np.random.default_rng(seed)
    return {"hq_video": rng.uniform(-1, 1, (1, F, S, S, 3)).astype(np.float32),
            "lq_video": rng.uniform(-1, 1, (1, F, S, S, 3)).astype(np.float32),
            "hq_image": rng.uniform(-1, 1, (1, 1, S, S, 3)).astype(np.float32),
            "lq_image": rng.uniform(-1, 1, (1, 1, S, S, 3)).astype(np.float32)}


def test_two_sft_steps_match_jax(models, monkeypatch, tmp_path):
    """DOVES2Trainer.train_step twice under SFT (scripts/train_s2.sh's)
    against the JAX trainer's step (its coin flip, per-frame encode, jitted
    loss and update), from the same DiT, VAE and DISTS weights, with a seed
    whose first step trains on the image pair and second on the clip. The
    LoRA step's stage-2 loss and gradients are held to JAX by
    test_stage2_loss_and_dit_grads_match_jax, its update by
    tests/test_torch_train.py."""
    *_, wpath = models
    monkeypatch.setenv("DOVE_DISTS_WEIGHTS", wpath)
    _sample_mean(monkeypatch)
    seed = next(s for s in range(100) if [_flip(s, 0, 0.5), _flip(s, 1, 0.5)]
                == [True, False])
    over = dict(seed=seed, training_type="sft")
    batch = _pixel_batch(6)

    tj = jtrainer.DOVES2Trainer(_args(jargs, tmp_path / "j", **over))
    tj.load_components()
    dit0, vae0 = (jax.tree.map(np.asarray, t) for t in (tj.dit_params, tj.vae_params))
    tj.prepare_optimizer(2)
    step_fn = tj.build_train_step()
    frozen = tj.frozen_params()
    dev_batch = tj._device_batch(batch)
    ref = []
    with tj.mesh:
        for _ in range(2):
            trainable, tj.opt_state, loss, aux, gnorm = step_fn(
                tj.trainable_params(), tj.opt_state, frozen, dev_batch,
                jax.random.PRNGKey(0))
            tj._set_trainable(trainable)
            tj.global_step += 1
            ref.append((float(loss), float(gnorm), set(aux)))

    tt = ttrainer.DOVES2Trainer(_args(targs, tmp_path / "t", **over), device="cpu")
    tt.load_components()
    tt.dit, tt.vae = tweights.from_jax_params(tt.config, dit0, vae0)
    tt.dit.requires_grad_(True)
    tt.prepare_optimizer(2)
    for want, image in zip(ref, (True, False)):
        assert tt.image_step(tt.global_step) == image
        loss, aux, gnorm = tt.train_step(tt.device_batch(batch))
        tt.global_step += 1
        assert set(aux) == want[2]
        assert ("loss_frame_diff" in aux) == (not image)
        np.testing.assert_allclose(float(loss), want[0], rtol=LOSS_RTOL)
        np.testing.assert_allclose(float(gnorm), want[1], rtol=1e-4)
        assert float(gnorm) > tt.args.max_grad_norm  # the clip is active
        assert set(tt.step_times) == {"encode", "dit_fwd_bwd", "dit_fwd", "decode",
                                      "perceptual", "backward", "optimizer", "vae.norm_n"}
        assert tt.step_times["dit_fwd_bwd"] >= tt.step_times["backward"]
    ours = tt.dit.state_dict()
    for k, v in tweights.jax_dit_to_diffusers(
            jax.tree.map(np.asarray, tj.dit_params)).items():
        np.testing.assert_allclose(ours[k].numpy(), v, atol=1e-6, rtol=0)


def test_perceptual_needs_weights_or_opt_in(monkeypatch, tmp_path):
    """The same RuntimeError as the JAX trainer without a weight file and
    without allow_random_perceptual; with it, the seeded VGG16."""
    monkeypatch.delenv("DOVE_DISTS_WEIGHTS", raising=False)
    errors = []
    for mod, make in ((jargs, lambda a: jtrainer.DOVES2Trainer(a)),
                      (targs, lambda a: ttrainer.DOVES2Trainer(a, device="cpu"))):
        tr = make(_args(mod, tmp_path))
        with pytest.raises(RuntimeError, match="allow_random_perceptual") as err:
            tr.load_components()
        errors.append(str(err.value))
    assert errors[0] == errors[1]
    tr = ttrainer.DOVES2Trainer(_args(targs, tmp_path, allow_random_perceptual=True),
                                device="cpu")
    tr.load_components()
    assert tr.perceptual_fn is not None


@pytest.mark.parametrize("weights", [
    dict(dists_weight=1.0, lpips_weight=2.0),
    dict(ea_dists_weight=0.5, dists_weight=1.0, ea_lpips_weight=3.0),
    dict(ea_lpips_weight=0.25, lpips_weight=1.0),
    dict(lpips_weight=0.75),
    dict(use_perceptual_loss=True),
    dict(),
])
def test_perceptual_choice_matches_jax(monkeypatch, tmp_path, weights):
    """elif precedence ea_dists > dists > ea_lpips > lpips: which metric is
    built (kind, edge-aware, weight file) and which weight it carries."""
    monkeypatch.setenv("DOVE_DISTS_WEIGHTS", "d.pt")
    monkeypatch.setenv("DOVE_LPIPS_WEIGHTS", "l.pt")
    built_j, built_t = [], []
    monkeypatch.setattr(jtrainer.Trainer, "load_components", lambda self: None)
    monkeypatch.setattr(ttrainer.Trainer, "load_components", lambda self: None)
    monkeypatch.setattr(jlosses, "make_perceptual_fn",
                        lambda kind, edge_aware, weights_path: built_j.append(
                            (kind, edge_aware, weights_path)) or "fn")
    monkeypatch.setattr(tlosses, "make_perceptual_fn",
                        lambda kind, edge_aware, weights_path, device: built_t.append(
                            (kind, edge_aware, weights_path)) or "fn")
    over = dict(dists_weight=0.0, frame_diff_weight=0.0, allow_random_perceptual=True,
                training_type="sft")
    over.update(weights)
    jtrainer.DOVES2Trainer(_args(jargs, tmp_path, **over)).load_components()
    tt = ttrainer.DOVES2Trainer(_args(targs, tmp_path, **over), device="cpu")
    tt.load_components()
    assert built_t == built_j
    assert len(built_t) == int(bool(weights))
    # the weight compute_loss gives the one built term
    seen = {}
    monkeypatch.setattr(tlosses, "stage2_loss", lambda *a, **kw: seen.update(kw))
    monkeypatch.setattr(ttrainer.DOVES2Trainer, "_encode",
                        lambda self, v, gen, per_frame: torch.zeros((1, 1, 4, 4, 8)))
    tt.dit = tt.vae = None
    tt.compute_loss({"lq_video": None, "hq_video": None, "prompt_embeds": None}, 0)
    order = ("ea_dists_weight", "dists_weight", "ea_lpips_weight", "lpips_weight")
    want = next((over[k] for k in order if over.get(k, 0.0) > 0), 0.0)
    assert seen["perceptual_weight"] == want
    assert seen["perceptual_fn"] == ("fn" if weights else None)


def test_registry_has_stage2():
    for training_type in ("lora", "sft"):
        assert ttrainer.get_model_cls("dove-s2", training_type) is ttrainer.DOVES2Trainer
        assert jtrainer.get_model_cls("dove-s2", training_type).__name__ == "DOVES2Trainer"
    # every stage-2 field of Args is accepted (none raises "not ported")
    targs.Args(model_path="x", model_name="dove-s2", image_ratio=0.8,
               use_perceptual_loss=True, allow_random_perceptual=True,
               ea_dists_weight=1.0, dists_weight=1.0, ea_lpips_weight=1.0,
               lpips_weight=1.0, frame_diff_weight=1.0)
