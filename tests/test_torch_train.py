"""Stage-1 LoRA training in the PyTorch port against dove_tpu, on tiny_test().

fp32 on the CPU. The same parameters, LoRA trees, batches and gradients,
made with numpy, go through the JAX package's training code and the port's:
the LoRA merge, the stage-1 loss and its LoRA gradients (default and flash
attention, with and without gradient checkpointing), every learning-rate
schedule, AdamW and Adam with global-norm clipping against optax, two
trainer steps against ``build_train_step``, the peft export, the ``Args``
schema and ``fuse_lora_into_dit``. Checkpoint save, rotation and resume are
the port's own and are checked against an uninterrupted run.
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from dove_tpu import config as jcfg
from dove_tpu import weights as jweights
from dove_tpu.models import dit as jdit
from dove_tpu.models import vae as jvae
from dove_tpu.ops.scheduler import Schedule as JSchedule
from dove_tpu.train import args as jargs
from dove_tpu.train import checkpointing as jckpt
from dove_tpu.train import lora as jlora
from dove_tpu.train import losses as jlosses
from dove_tpu.train import optim as joptim
from dove_tpu.train import trainer as jtrainer
from dove_tpu_torch import config as tcfg
from dove_tpu_torch import weights as tweights
from dove_tpu_torch.ops import flash_attention as fa
from dove_tpu_torch.ops.scheduler import Schedule
from dove_tpu_torch.train import args as targs
from dove_tpu_torch.train import checkpointing as tckpt
from dove_tpu_torch.train import lora as tlora
from dove_tpu_torch.train import losses as tlosses
from dove_tpu_torch.train import optim as toptim
from dove_tpu_torch.train import trainer as ttrainer
from torch_threads import two_torch_threads  # noqa: F401 (autouse)

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

RANK, ALPHA = 4, 2
SCALE = ALPHA / RANK
LOSS_RTOL = 1e-5  # fp32, different summation orders through 2 blocks
GRAD_TOL = 1e-4  # max |dgrad| relative to the largest gradient of the leaf
OPT_TOL = 1e-6  # optimizer and schedule arithmetic, fp32 against fp32


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


@pytest.fixture(scope="module")
def models():
    cfg_j = jcfg.tiny_test()
    dit_tree = _perturbed(jdit.init_dit_params(jax.random.PRNGKey(0), cfg_j.dit), 1)
    vae_tree = jax.tree.map(np.asarray,
                            jvae.init_vae_params(jax.random.PRNGKey(1), cfg_j.vae))
    dit, _ = tweights.from_jax_params(tcfg.tiny_test(), dit_tree, vae_tree)
    return cfg_j, dit_tree, dit


def _max_rel(ours: np.ndarray, ref: np.ndarray) -> float:
    return float(np.abs(ours - ref).max() / max(np.abs(ref).max(), 1e-30))


def test_apply_lora_matches_jax(models):
    cfg_j, dit_tree, dit = models
    tree = _lora_tree(cfg_j.dit, seed=2)
    merged_j = jweights_sd = tweights.jax_dit_to_diffusers(
        jlora.apply_lora(jax.tree.map(jnp.asarray, dit_tree),
                         jax.tree.map(jnp.asarray, tree), SCALE))
    lora_t = tweights.from_jax_lora(tree)
    assert all(x.requires_grad for ab in lora_t.values() for x in ab.values())
    merged = tlora.apply_lora(dit, lora_t, SCALE).state_dict()
    for key, ref in jweights_sd.items():
        np.testing.assert_allclose(merged[key].numpy(), ref, atol=1e-6, rtol=0)
    # the input DiT is untouched, and only the attention projections moved
    base = tweights.jax_dit_to_diffusers(dit_tree)
    assert torch.equal(dit.state_dict()["transformer_blocks.0.attn1.to_q.weight"],
                       torch.from_numpy(base["transformer_blocks.0.attn1.to_q.weight"]))
    moved = {k for k in base if not np.array_equal(base[k], merged_j[k])}
    assert moved == {f"transformer_blocks.{i}.attn1.{t}.weight" for i in range(2)
                     for t in ("to_q", "to_k", "to_v", "to_out.0")}
    assert tlora.lora_param_count(lora_t) == sum(x.size for ab in tree.values()
                                                 for x in ab.values())


@pytest.mark.parametrize("backend", [None, "flash"])
@pytest.mark.parametrize("remat", [False, True])
def test_stage1_loss_and_lora_grads_match_jax(models, backend, remat):
    cfg_j, dit_tree, dit = models
    tree = _lora_tree(cfg_j.dit, seed=3)
    rng = np.random.default_rng(4)
    batch = {
        "lq_latent": rng.standard_normal((2, 3, 8, 6, 8)).astype(np.float32),
        "hq_latent": rng.standard_normal((2, 3, 8, 6, 8)).astype(np.float32),
        "prompt_embeds": rng.standard_normal((2, 7, 32)).astype(np.float32),
    }
    sched_j = JSchedule.create(cfg_j.scheduler)
    params_j = jax.tree.map(jnp.asarray, dit_tree)

    def loss_j(lora):
        eff = jlora.apply_lora(params_j, lora, SCALE)
        return jlosses.stage1_loss(
            cfg_j, sched_j, eff, jax.tree.map(jnp.asarray, batch), None,
            remat=remat, attention_backend=backend)

    (ref_loss, ref_aux), ref_grads = jax.value_and_grad(loss_j, has_aux=True)(
        jax.tree.map(jnp.asarray, tree))

    cfg_t = tcfg.tiny_test()
    lora_t = tweights.from_jax_lora(tree)
    for c in (fa.launches_lse, fa.launches_bwd_dq, fa.launches_bwd_dkv):
        c.reset()
    loss, aux = tlosses.stage1_loss(
        cfg_t, Schedule.create(cfg_t.scheduler), dit,
        {k: torch.from_numpy(v) for k, v in batch.items()},
        attention_backend=backend, lora=lora_t, lora_scale=SCALE,
        gradient_checkpointing=remat)
    loss.backward()
    loss = loss.detach()
    np.testing.assert_allclose(float(loss), float(ref_loss), rtol=LOSS_RTOL)
    assert float(aux["loss_mse"].detach()) == float(loss)
    for t in tlora.TARGETS:
        for ab in ("A", "B"):
            ours = lora_t[t][ab].grad.numpy()
            ref = np.asarray(ref_grads[t][ab])
            assert np.abs(ref).max() > 0
            assert _max_rel(ours, ref) <= GRAD_TOL, (t, ab, _max_rel(ours, ref))
    assert dit.transformer_blocks[0].attn1.to_q.weight.grad is None  # frozen
    assert fa.launches_lse.count == fa.launches_bwd_dq.count == 0


SCHEDULES = [
    ("constant", 0), ("constant", 3), ("constant_with_warmup", 3),
    ("linear", 0), ("warmup_decay", 3), ("cosine", 3), ("cosine", 0),
    ("cosine_with_restarts", 3), ("polynomial", 3),
]


@pytest.mark.parametrize("kind,warmup", SCHEDULES)
def test_lr_schedules_match_optax(kind, warmup):
    kw = dict(warmup_steps=warmup, total_steps=12, kind=kind, num_cycles=2, power=2.0)
    ref = joptim.make_lr_schedule(1e-3, **kw)
    ours = toptim.make_lr_schedule(1e-3, **kw)
    counts = range(15)
    # optax evaluates in fp32, the port in float64: within fp32 rounding of
    # the peak rate
    np.testing.assert_allclose([ours(c) for c in counts],
                               [float(ref(jnp.asarray(c))) for c in counts],
                               rtol=OPT_TOL, atol=OPT_TOL * 1e-3)
    if warmup:
        assert ours(0) == 0.0  # a warmup's first step has lr 0
    with pytest.raises(ValueError):
        toptim.make_lr_schedule(1e-3, kind="nope")


@pytest.mark.parametrize("name", ["adamw", "adam"])
def test_optimizers_with_clipping_match_optax(name):
    """Five steps on one tree, with max_grad_norm between the gradients'
    norms so that some steps clip and some do not, and a warmup."""
    rng = np.random.default_rng(7)
    shapes = [(3, 5), (4,), (2, 3, 2)]
    params = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    grads = [[(0.3 + 0.4 * i) * rng.standard_normal(s).astype(np.float32)
              for s in shapes] for i in range(5)]
    kw = dict(betas=(0.9, 0.95), eps=1e-8, weight_decay=0.05, max_grad_norm=2.0)
    sched_j = joptim.make_lr_schedule(1e-2, warmup_steps=2, kind="constant_with_warmup")
    opt_j = joptim.make_optimizer(name, sched_j, **kw)
    p_j = [jnp.asarray(p) for p in params]
    state_j = opt_j.init(p_j)

    opt = toptim.make_optimizer(
        name, toptim.make_lr_schedule(1e-2, warmup_steps=2,
                                      kind="constant_with_warmup"), **kw)
    p_t = [torch.from_numpy(p.copy()) for p in params]
    opt.init(p_t)
    clipped = []
    for g in grads:
        g_j = [jnp.asarray(x) for x in g]
        upd, state_j = opt_j.update(g_j, state_j, p_j)
        p_j = optax.apply_updates(p_j, upd)
        norm = opt.step(p_t, [torch.from_numpy(x) for x in g])
        np.testing.assert_allclose(float(norm), float(optax.global_norm(g_j)),
                                   rtol=OPT_TOL)
        clipped.append(float(norm) >= 2.0)
        for ours, ref in zip(p_t, p_j):
            np.testing.assert_allclose(ours.numpy(), np.asarray(ref),
                                       rtol=OPT_TOL, atol=1e-7)
    assert any(clipped) and not all(clipped)
    assert opt.count == 5


def test_unported_optimizers_raise():
    """Every name of the JAX package's make_optimizer builds now (their
    updates are held to optax in tests/test_torch_optim.py), underscores read
    as dashes; a name it does not know raises as there."""
    sched = toptim.make_lr_schedule(1e-3)
    for name in ("came", "prodigy", "adamw-8bit", "adamw_4bit", "adam-8bit", "adam-4bit"):
        opt = toptim.make_optimizer(name, sched)
        opt.init([torch.zeros(3, 4)])
        assert opt.count == 0 and opt.state_dict()["count"] == 0
    for bad in ("sgd", "lion"):
        with pytest.raises(ValueError):
            toptim.make_optimizer(bad, sched)
        with pytest.raises(ValueError):
            joptim.make_optimizer(bad, joptim.make_lr_schedule(1e-3))


# ---------------------------------------------------------------------------
# The trainer
# ---------------------------------------------------------------------------

def _args(mod, tmp_path, **over):
    kw = dict(
        model_path=tmp_path / "nonexistent_model", model_name="dove-s1",
        base_preset="tiny", training_type="lora", rank=RANK, lora_alpha=ALPHA,
        output_dir=tmp_path / "out", data_root=tmp_path,
        train_resolution=(5, 32, 32), batch_size=2, train_steps=2,
        checkpointing_steps=100, mixed_precision="no", num_workers=0,
        learning_rate=1e-3, lr_warmup_steps=0, lr_scheduler="constant",
        max_grad_norm=1e-4, stastic_frequency=0,
    )
    kw.update(over)
    return mod.Args(**kw)


def _latent_batch(seed: int) -> dict[str, np.ndarray]:
    rng = np.random.default_rng(seed)
    return {"lq_latent": rng.standard_normal((2, 3, 8, 6, 8)).astype(np.float32),
            "hq_latent": rng.standard_normal((2, 3, 8, 6, 8)).astype(np.float32)}


def test_two_train_steps_match_jax(tmp_path):
    """DOVES1Trainer.train_step twice on one precomputed-latent batch against
    the JAX trainer's jitted build_train_step, from the same DiT and LoRA
    (B nonzero), with noise_step 0 so that no random draw enters the step."""
    from dove_tpu.parallel import mesh as mesh_mod

    tree = _lora_tree(jcfg.tiny_test().dit, seed=5)
    batch = _latent_batch(6)

    tj = jtrainer.DOVES1Trainer(_args(jargs, tmp_path / "j"))
    tj.load_components()
    tj.lora_params = mesh_mod.shard_params(jax.tree.map(jnp.asarray, tree), tj.mesh,
                                           "model")
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
            ref.append((float(loss), float(gnorm)))

    tt = ttrainer.DOVES1Trainer(_args(targs, tmp_path / "t"), device="cpu")
    tt.load_components()
    tt.dit, _ = tweights.from_jax_params(
        tt.config, jax.tree.map(np.asarray, tj.dit_params),
        jax.tree.map(np.asarray, tj.vae_params))
    tt.lora_params = tweights.from_jax_lora(tree)
    tt.prepare_optimizer(2)
    for want in ref:
        loss, aux, gnorm = tt.train_step(tt.device_batch(batch))
        tt.global_step += 1
        np.testing.assert_allclose(float(loss), want[0], rtol=LOSS_RTOL)
        np.testing.assert_allclose(float(gnorm), want[1], rtol=1e-4)
        assert float(gnorm) > tt.args.max_grad_norm  # the clip is active
        assert set(tt.step_times) == {"encode", "dit_fwd_bwd", "optimizer"}
    for t in tlora.TARGETS:
        for ab in ("A", "B"):
            ours = tt.lora_params[t][ab].detach().numpy()
            np.testing.assert_allclose(ours, np.asarray(tj.lora_params[t][ab]),
                                       atol=1e-6, rtol=0)
            assert not np.array_equal(ours, tree[t][ab])  # every leaf moved


def test_train_checkpoint_rotate_resume(tmp_path):
    """train() over a loader with checkpoints every step and a limit of 2,
    then a fresh trainer resumes from the newest and matches an
    uninterrupted run step for step; the pixel batch goes through the VAE
    encode with (seed, step)-seeded posterior noise."""
    rng = np.random.default_rng(8)
    batch = {"hq_video": rng.uniform(-1, 1, (2, 5, 32, 32, 3)).astype(np.float32),
             "lq_video": rng.uniform(-1, 1, (2, 5, 32, 32, 3)).astype(np.float32)}

    def trainer(out, steps):
        tr = ttrainer.DOVES1Trainer(
            _args(targs, tmp_path, output_dir=tmp_path / out, train_steps=steps,
                  checkpointing_steps=1, checkpointing_limit=2, lr_warmup_steps=2,
                  lr_scheduler="constant_with_warmup"),
            device="cpu")
        tr.load_components()
        tr.prepare_optimizer(steps)
        tr.loader = [batch]
        return tr

    full = trainer("full", 4)
    full.train(4, 1)
    a = trainer("a", 3)
    a.train(3, 1)
    assert [p.name for _, p in tckpt.list_checkpoints(tmp_path / "a")] == [
        "checkpoint-2", "checkpoint-3"]
    b = trainer("a", 4)
    b.maybe_resume()
    assert b.global_step == 3 and b.optimizer.count == 3
    b.train(4, 1)
    assert [s for s, _ in tckpt.list_checkpoints(tmp_path / "a")] == [3, 4]
    for t in tlora.TARGETS:
        for ab in ("A", "B"):
            assert torch.equal(b.lora_params[t][ab], full.lora_params[t][ab])
    assert not torch.equal(full.lora_params["to_q"]["B"], torch.zeros(()))
    log = (tmp_path / "a" / "train_log.jsonl")
    assert not log.exists()  # train() logs only when fit() opened the log


def test_lora_export_matches_jax(tmp_path):
    from safetensors.numpy import load_file

    tree = _lora_tree(jcfg.tiny_test().dit, seed=9)
    jckpt.export_lora_safetensors(jax.tree.map(jnp.asarray, tree),
                                  tmp_path / "j" / "pytorch_lora_weights.safetensors")
    tckpt.export_lora_safetensors(tweights.from_jax_lora(tree),
                                  tmp_path / "t" / "pytorch_lora_weights.safetensors")
    ref = load_file(str(tmp_path / "j" / "pytorch_lora_weights.safetensors"))
    ours = load_file(str(tmp_path / "t" / "pytorch_lora_weights.safetensors"))
    assert sorted(ours) == sorted(ref) and len(ref) == 2 * 4 * 2
    for k in ref:
        assert ours[k].dtype == ref[k].dtype and np.array_equal(ours[k], ref[k])


def test_fuse_lora_into_dit_matches_jax(models):
    cfg_j, dit_tree, _ = models
    tree = _lora_tree(cfg_j.dit, seed=10)
    peft = tckpt.lora_state_dict(tweights.from_jax_lora(tree))
    ref = tweights.jax_dit_to_diffusers(jweights.fuse_lora_into_dit(
        jax.tree.map(jnp.asarray, dit_tree), peft, scale=SCALE))
    dit, _ = tweights.from_jax_params(
        tcfg.tiny_test(), dit_tree,
        jax.tree.map(np.asarray, jvae.init_vae_params(jax.random.PRNGKey(1),
                                                      cfg_j.vae)))
    out = tweights.fuse_lora_into_dit(dit, peft, scale=SCALE).state_dict()
    for key, want in ref.items():
        np.testing.assert_allclose(out[key].numpy(), want, atol=1e-6, rtol=0)
    # the fused DiT is the DiT the LoRA merge gives
    merged = tlora.apply_lora(tweights.from_jax_params(
        tcfg.tiny_test(), dit_tree, jax.tree.map(np.asarray, jvae.init_vae_params(
            jax.random.PRNGKey(1), cfg_j.vae)))[0], tweights.from_jax_lora(tree), SCALE)
    for key, want in merged.state_dict().items():
        torch.testing.assert_close(out[key], want, atol=1e-6, rtol=0)
    with pytest.raises(ValueError, match="no recognizable"):
        tweights.fuse_lora_into_dit(dit, {"foo": np.zeros(1)})
    bad = {k.replace("blocks.1.", "blocks.7."): v for k, v in peft.items()}
    with pytest.raises(ValueError, match="mismatch"):
        tweights.fuse_lora_into_dit(dit, bad)


# ---------------------------------------------------------------------------
# Args
# ---------------------------------------------------------------------------

def test_args_fields_and_defaults_match_jax():
    ref = jargs.Args(model_path="x").model_dump()
    ours = targs.Args(model_path="x").model_dump()
    assert list(ours) == list(ref)
    for name in ref:
        if name == "output_dir":  # the time of import, in both packages
            assert str(ours[name]).startswith("train_results/")
            continue
        assert ours[name] == ref[name], name


@pytest.mark.parametrize("bad", [
    dict(train_resolution="25x321x640"),
    dict(train_resolution="24x320x640"),
    dict(train_resolution="25x320"),
    dict(do_validation=True),
    dict(model_type="real-sr-image-video"),
    dict(sr_noise_step=1000),
    dict(noise_step=-1),
    dict(tensor_parallel=2, fsdp=2),
    dict(training_type="full"),
])
def test_args_validation_errors_match_jax(bad):
    with pytest.raises(ValueError):
        jargs.Args(model_path="x", **bad)
    with pytest.raises(ValueError):
        targs.Args(model_path="x", **bad)


def test_args_parse_and_dump(tmp_path):
    argv = ["--model_path", "m", "--train_resolution", "9x32x64", "--rank", "8",
            "--gradient_checkpointing", "false", "--target_modules", "to_q", "to_v",
            "--learning_rate", "3e-4", "--resume_from_checkpoint", "o/checkpoint-5"]
    ref = jargs.Args.parse_args(argv).model_dump()
    ours = targs.Args.parse_args(argv).model_dump()
    for name in ref:
        if name != "output_dir":
            assert ours[name] == ref[name], name
    args = targs.Args(model_path="m", train_resolution="9x32x64")
    args.dump_yaml(tmp_path / "args.yaml")
    import yaml  # the dump is YAML that reads back as the same values

    loaded = yaml.safe_load((tmp_path / "args.yaml").read_text())
    assert loaded["train_resolution"] == [9, 32, 64]
    assert loaded["model_path"] == "m" and loaded["validation_dir"] is None
    assert loaded["target_modules"] == ["to_q", "to_k", "to_v", "to_out.0"]


@pytest.mark.parametrize("later", [
    dict(fsdp=2), dict(tensor_parallel=2), dict(multihost=True),
    dict(use_optical_flow=True), dict(report_to="wandb"),
    dict(do_validation=True, validation_dir="v"), dict(is_latent=True),
])
def test_args_of_later_slices_raise(later):
    """The options that later slices ported (the mesh's fsdp,
    tensor_parallel and multihost, use_optical_flow, report_to,
    do_validation, is_latent) once raised here; each now gives the JAX
    package's Args."""
    ref = jargs.Args(model_path="x", **later)  # valid in the JAX package
    ours = targs.Args(model_path="x", **later).model_dump()
    for name, want in ref.model_dump().items():
        if name != "output_dir":  # the time of import, in both packages
            got = ours[name]
            assert (str(got) if isinstance(got, Path) else got) == (
                str(want) if isinstance(want, Path) else want), name


def test_registry_views_and_unported_parts(tmp_path):
    assert ttrainer.get_model_cls("dove-s1", "lora") is ttrainer.DOVES1Trainer
    assert ttrainer.get_model_cls("dove-s1", "sft") is ttrainer.DOVES1Trainer
    assert ttrainer.get_model_cls("dove-s2", "lora") is ttrainer.DOVES2Trainer
    assert ttrainer.get_model_cls("dove-s2", "sft") is ttrainer.DOVES2Trainer
    with pytest.raises(ValueError):
        ttrainer.get_model_cls("nope", "lora")

    tr = ttrainer.DOVES1Trainer(_args(targs, tmp_path), device="cpu")
    tr.load_components()
    comps = tr.components
    assert comps.transformer is tr.dit and comps.vae is tr.vae
    assert comps.scheduler is tr.schedule and comps.unet is None
    st = tr.state
    assert (st.train_frames, st.train_height, st.train_width) == (5, 32, 32)
    assert st.weight_dtype == torch.float32 and not st.using_deepspeed
    assert st.num_trainable_parameters == tlora.lora_param_count(tr.lora_params)
    assert st.transformer_config == dataclasses.asdict(tr.config.dit)
    assert not any(p.requires_grad for p in tr.dit.parameters())
    # the parts a later slice ported run: the dataset and its loader, fit
    # through its two steps, and validate (nothing to validate without a
    # validation_dir, as in the JAX package)
    data = _one_image_dataset(tmp_path)
    tr = ttrainer.DOVES1Trainer(_args(targs, tmp_path, **data), device="cpu")
    tr.load_components()
    tr.prepare_dataset()
    assert len(tr.loader) == 1
    batch = next(iter(tr.loader))
    assert batch["hq_video"].shape == (2, 1, 32, 32, 3) and batch["prompt"] == ["", ""]
    assert tr.validate(1) == {}
    tr.fit()
    assert tr.global_step == 2 and len(tr.data_wait_s) == 2
    assert (tmp_path / "out" / "args.yaml").exists()
    log = [json.loads(x) for x in (tmp_path / "out" / "train_log.jsonl").read_text().splitlines()]
    assert "video_compression_backend" in log[0] and [r["step"] for r in log[1:]] == [1, 2]
    # the trackers and gradient accumulation, ported since: the Args hold them
    # as the JAX package's, and k > 1 wraps the optimizer as optax.MultiSteps
    assert targs.Args(model_path="x", report_to="tensorboard").report_to == "tensorboard"
    accum = ttrainer.DOVES1Trainer(
        _args(targs, tmp_path, gradient_accumulation_steps=2), device="cpu")
    accum.load_components()
    accum.prepare_optimizer(2)
    assert isinstance(accum.optimizer, toptim.MultiSteps)
    assert accum.optimizer.every_k == 2 and accum.optimizer.count == 0


def _one_image_dataset(tmp_path) -> dict:
    """A manifest of two PNG images (one-frame clips) and a degradation config
    of a blur and a 4x downscale: what prepare_dataset needs."""
    from PIL import Image

    root = tmp_path / "data"
    root.mkdir()
    for i in range(2):
        Image.fromarray(np.random.default_rng(i).integers(0, 255, (48, 48, 3), np.uint8)
                        ).save(root / f"img{i}.png")
    (root / "list.txt").write_text("img0.png\nimg1.png\n")
    (root / "deg.yaml").write_text(
        "degradation_1:\n  random_blur:\n    params:\n      kernel_size: [7]\n"
        "      kernel_list: ['iso']\n      kernel_prob: [1]\n"
        "degradation_2:\n  random_resize:\n    params:\n      target_size: [12, 12]\n"
        "      resize_opt: ['area']\n      resize_prob: [1]\n")
    return dict(data_root=root, video_column=root / "list.txt",
                degradation_config=str(root / "deg.yaml"))


def test_sft_trains_the_whole_dit_and_exports(tmp_path):
    tr = ttrainer.DOVES1Trainer(_args(targs, tmp_path, training_type="sft"),
                                device="cpu")
    tr.load_components()
    tr.prepare_optimizer(1)
    before = tr.dit.proj_out.weight.detach().clone()
    loss, _, gnorm = tr.train_step(tr.device_batch(_latent_batch(11)))
    assert np.isfinite(float(loss)) and float(gnorm) > 0
    assert not torch.equal(tr.dit.proj_out.weight, before)
    tr.export(tmp_path / "export")
    assert list((tmp_path / "export" / "transformer").glob("*.safetensors"))


def test_port_imports_nothing_the_card_lacks():
    """The machine with the card has no pydantic, PyYAML, optax, orbax,
    safetensors or cv2: importing every module of the port (and
    chip_smoke.py), the stage-2 ones included, loads none of them, nor
    JAX."""
    import subprocess
    import sys
    from pathlib import Path

    repo = Path(__file__).resolve().parents[1]
    mods = sorted(".".join(p.relative_to(repo).with_suffix("").parts)
                  for p in (repo / "dove_tpu_torch").rglob("*.py"))
    assert {"dove_tpu_torch.eval.vgg", "dove_tpu_torch.eval.dists",
            "dove_tpu_torch.eval.lpips", "dove_tpu_torch.train.losses",
            "dove_tpu_torch.train.tracking", "dove_tpu_torch.train.optim"} <= set(mods)
    banned = ("jax", "dove_tpu", "pydantic", "yaml", "optax", "orbax", "safetensors",
              "cv2")
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m.removesuffix('.__init__'))\n"
        "import chip_smoke\n"
        f"bad = [m for m in sys.modules if m.split('.')[0] in {banned!r}]\n"
        "assert not bad, bad\n"
        "print('clean')\n"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=repo,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "clean"
