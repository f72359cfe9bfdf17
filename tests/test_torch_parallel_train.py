"""Training on a mesh in the PyTorch port (DDP over "data", FSDP or tensor
parallelism over "model", the multi-process launch) against one device and
the JAX package, on the CPU.

The ranks are spawned gloo processes (``tests/torch_parallel_ranks.py``,
JAX-free) that build ``DOVES1Trainer`` from a diffusers-layout checkpoint of
the JAX package's seeded tiny_test() weights. The bars are the JAX
package's own:

  * one SFT and one LoRA step on data=2 x model=2 (DDP + TP): the loss
    within 1e-5 of one device's and of JAX's ``stage1_loss``, the updated
    weights within rel 5e-4 (tests/test_tp_train.py:61-91);
  * sequence-parallel gradients (B = 1 on 2x2) within rel 1e-4 of JAX's
    single-device gradients (tests/test_tp_train.py:94-120);
  * the loss and the gradient norm under FSDP invariant to the layout,
    rtol 2e-5 (tests/test_parallel.py:56-100);
  * a checkpoint written under FSDP restores exactly under TP, and training
    goes on (tests/test_tp_train.py's cross-layout resume); LoRA under TP
    with CAME and the 8-bit AdamW resumes to the state of the run it
    interrupted;
  * the optimizers whose statistics span a whole tensor (CAME, Prodigy,
    the 8- and 4-bit AdamW) on tensors that fsdp or tensor_parallel split
    (odd sizes, a column and a row split, uneven FSDP chunks, an empty one,
    replicated gains): two steps equal one device's bit for bit (Prodigy,
    whose sums over the model add the shards' partial sums: rel 1e-6), and
    a step-1 checkpoint restored under another layout or one device takes
    step 2 to the same place (under its own layout bit for bit, Prodigy
    too); every one of these runs is also held to the JAX package's
    optimizer on the whole tensors, at tests/test_torch_optim.py's bars
    (the parameters within 1e-6 of the tensor's largest value, 1e-5 for
    CAME and Prodigy; the low-bit codes equal but near a tie); an SFT step
    with CAME under data=2 x model=2 is held to one device's at the bars
    above;
  * ``python -m dove_tpu_torch.train --multihost true`` in two processes:
    both ranks log the same losses, rank 0 alone writes, the checkpoint
    restores (tests/test_multihost.py).
"""

from __future__ import annotations

import dataclasses
import json
import os
import re
import subprocess
import sys
from pathlib import Path

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import torch_parallel_ranks as ranks
from dove_tpu import config as jcfg
from dove_tpu.models import dit as jdit
from dove_tpu.models import vae as jvae
from dove_tpu.ops.scheduler import Schedule as JSchedule
from dove_tpu.train import args as jargs
from dove_tpu.train import optim as joptim
from dove_tpu.train.losses import stage1_loss as jstage1_loss
from dove_tpu_torch import safetensors_io
from dove_tpu_torch import weights as tweights
from dove_tpu_torch.parallel.tp import Group, Split
from dove_tpu_torch.train import args as targs
from dove_tpu_torch.train.optim import make_lr_schedule, make_optimizer
from test_trainer import TINY_DEGRADATION, _write_clip
from test_torch_optim import PARAM_TOL, _check_codes, _pre_round
from torch_threads import two_torch_threads  # noqa: F401 (autouse)

REPO = Path(__file__).resolve().parents[1]
MESH = dict(data_parallel=2, tensor_parallel=2)
FSDP_LAYOUTS = [(2, 2), (1, 4), (4, 1)]
RESUME_OPTS = ("came", "adamw-8bit")
WHOLE_STAT_OPTS = ["came", "prodigy", "adamw_8bit", "adamw-4bit"]
# tensors split over two ranks: a column and a row split (TP), torch.chunk's
# uneven and empty FSDP parts, and gains every TP rank holds whole
OPT_SHAPES = [(6, 5), (5, 6), (6,), (7,), (64, 100), (1, 4), (3, 4)]
OPT_LAYOUTS = {"tensor_parallel": [0, 1, 0, None, 1, None, None],
               "fsdp": [0] * len(OPT_SHAPES)}
OPT_LR = 1e-2  # torch_parallel_ranks._opt_run's: constant, no clip
PRODIGY_REL = 1e-6


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """The checkpoint, two clips, the latent batches and the ranks' runs."""
    work = tmp_path_factory.mktemp("ptrain")
    cfg = jcfg.tiny_test()
    dit = jax.tree.map(np.asarray, jdit.init_dit_params(jax.random.PRNGKey(0), cfg.dit))
    vae = jax.tree.map(np.asarray, jvae.init_vae_params(jax.random.PRNGKey(1), cfg.vae))
    ckpt = work / "ckpt"
    for sub, tensors, conf in (("transformer", tweights.jax_dit_to_diffusers(dit), cfg.dit),
                               ("vae", tweights.jax_vae_to_diffusers(vae), cfg.vae)):
        (ckpt / sub).mkdir(parents=True)
        safetensors_io.save_file(tensors, ckpt / sub / "diffusion_pytorch_model.safetensors")
        (ckpt / sub / "config.json").write_text(json.dumps(dataclasses.asdict(conf)))
    (ckpt / "scheduler").mkdir()
    (ckpt / "scheduler" / "scheduler_config.json").write_text(
        json.dumps(dataclasses.asdict(cfg.scheduler)))
    data = work / "data"
    (data / "videos").mkdir(parents=True)
    for i in range(2):
        _write_clip(data / "videos" / f"clip{i}.mp4")
    (data / "videos.txt").write_text("videos/clip0.mp4\nvideos/clip1.mp4\n")
    (data / "degradation.yaml").write_text(TINY_DEGRADATION)
    (data / "val" / "clip0").mkdir(parents=True)
    for i, frame in enumerate(np.random.default_rng(5).integers(0, 255, (9, 8, 8, 3))):
        cv2.imwrite(str(data / "val" / "clip0" / f"{i:04d}.png"), frame.astype(np.uint8))

    C, L, D = cfg.dit.in_channels, cfg.dit.max_text_seq_length, cfg.dit.text_embed_dim
    rng = np.random.default_rng(7)
    batch = {"lq_latent": rng.normal(size=(4, 3, 4, 8, C)).astype(np.float32),
             "hq_latent": rng.normal(size=(4, 3, 4, 8, C)).astype(np.float32),
             "prompt_embedding": rng.normal(size=(4, L, D)).astype(np.float32)}
    ramp = np.linspace(-1, 1, 2 * 4 * 8 * C, dtype=np.float32).reshape(1, 2, 4, 8, C)
    fsdp_batch = {"lq_latent": np.repeat(ramp, 4, axis=0),
                  "hq_latent": np.zeros((4, 2, 4, 8, C), np.float32),
                  "prompt_embedding": np.zeros((4, L, D), np.float32)}
    args = dict(model_path=str(ckpt), base_preset="tiny", output_dir=str(work / "out"),
                data_root=str(data), rank=4, lora_alpha=4, mixed_precision="no",
                learning_rate=1e-3, lr_warmup_steps=0, lr_scheduler="constant",
                batch_size=4, stastic_frequency=0, seed=3)
    fit_args = dict(args, training_type="sft", video_column=str(data / "videos.txt"),
                    degradation_config=str(data / "degradation.yaml"),
                    train_resolution="5x32x32", batch_size=1, num_workers=0,
                    output_dir=str(work / "fit"), validation_dir=str(data / "val"),
                    validation_ref_videos=str(data / "val"), eval_metric_list="psnr")
    inputs = dict(dit=dit, vae=vae, prompt=np.zeros((L, D), np.float32), batch=batch,
                  fsdp_batch=fsdp_batch, args=args, fit_args=fit_args, sp_mesh=(2, 2),
                  steps={w: {kind: (MESH if w > 1 else {}, dict(
                      training_type=kind.split("_")[0],
                      optimizer=kind.split("_")[1] if "_" in kind else "adamw"))
                      for kind in ("sft", "lora", "sft_came")} for w in (1, 4)},
                  fsdp={1: [(1, 1)], 4: FSDP_LAYOUTS}, resume_opts=RESUME_OPTS)
    ranks.dump(inputs, work / "in.pkl")
    out = {}
    for body, world in ((ranks.train_step, 4), (ranks.sp_grads, 4),
                        (ranks.fsdp_layouts, 4), (ranks.fit_then_resume, 2),
                        (ranks.resume_optimizers, 2)):
        path = work / f"{body.__name__}{world}.pkl"
        ranks.spawn(body, world, work, str(work / "in.pkl"), str(path))
        out[body.__name__] = ranks.load(path)
    # world size 1 in this process
    for body in (ranks.train_step, ranks.fsdp_layouts):
        path = work / f"{body.__name__}1.pkl"
        body(0, 1, str(work / "in.pkl"), str(path))
        out[body.__name__ + "1"] = ranks.load(path)
    return dict(cfg=cfg, dit=dit, batch=batch, fsdp_batch=fsdp_batch, out=out,
                ckpt=ckpt, data=data, work=work)


def _jax_loss(cfg, params, batch, grad=False):
    b = {"lq_latent": jnp.asarray(batch["lq_latent"]),
         "hq_latent": jnp.asarray(batch["hq_latent"]),
         "prompt_embeds": jnp.asarray(batch["prompt_embedding"])}
    schedule = JSchedule.create(cfg.scheduler)

    def loss(p):
        return jstage1_loss(cfg, schedule, p, b, jax.random.PRNGKey(3), remat=True)[0]

    params = jax.tree.map(jnp.asarray, params)
    return jax.value_and_grad(loss)(params) if grad else loss(params)


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / (np.abs(b).max() + 1e-12))


@pytest.mark.parametrize("kind", ["sft", "lora", "sft_came"])
def test_tp_train_step_matches_single_device(setup, kind):
    loss, gnorm, state = setup["out"]["train_step"][kind]
    loss1, gnorm1, state1 = setup["out"]["train_step1"][kind]
    jloss = float(_jax_loss(setup["cfg"], setup["dit"], setup["batch"]))
    for ref in (loss1, jloss):
        assert abs(loss - ref) < 1e-5 * max(1.0, abs(ref))
    np.testing.assert_allclose(gnorm, gnorm1, rtol=1e-5)
    assert state.keys() == state1.keys()
    worst = max(_rel(state[k], state1[k]) for k in state1)
    assert worst < 5e-4, f"worst rel err {worst:.2e}"


def test_sp_gradients_match_single_device(setup):
    """B = 1 cannot split over "data": those ranks carry sequence
    parallelism, the DiT is split over "model"; the gradients of every
    weight, held to JAX's single-device gradients."""
    b1 = {k: v[:1] for k, v in setup["batch"].items()}
    jl, jg = _jax_loss(setup["cfg"], setup["dit"], b1, grad=True)
    ref = tweights.jax_dit_to_diffusers(jax.tree.map(np.asarray, jg))
    ours = setup["out"]["sp_grads"]
    assert abs(ours["loss"] - float(jl)) < 1e-5 * max(1.0, abs(float(jl)))
    assert set(ours["grads"]) <= set(ref)
    worst = max(_rel(g, ref[k]) for k, g in ours["grads"].items())
    assert worst < 1e-4, f"worst grad rel err {worst:.2e}"


@pytest.mark.parametrize("layout", FSDP_LAYOUTS)
def test_fsdp_loss_and_grad_norm_invariant_to_layout(setup, layout):
    loss, gnorm = setup["out"]["fsdp_layouts"][layout]
    loss1, gnorm1 = setup["out"]["fsdp_layouts1"][(1, 1)]
    jloss, jgrads = _jax_loss(setup["cfg"], setup["dit"], setup["fsdp_batch"], grad=True)
    np.testing.assert_allclose(loss, [loss1, float(jloss)], rtol=2e-5)
    np.testing.assert_allclose(gnorm, [gnorm1, float(optax.global_norm(jgrads))], rtol=2e-5)


def test_fsdp_checkpoint_resumes_under_tp(setup):
    """fit() under fsdp=2 writes checkpoint-1 (rank 0, the whole state); a
    tensor_parallel=2 trainer restores it exactly, trains step 2 and
    validates over the mesh (the FSDP trainer validated too): rank 0 writes
    the clip, both ranks return its summary."""
    res = setup["out"]["fit_then_resume"]
    assert res["restored_err"] == 0.0
    assert res["step"] == 2 and res["tp"] == 2
    for summaries in (res["fsdp_validation"], res["validation"]):
        first, second = summaries
        assert first == second and np.isfinite(first["psnr"])
    assert (setup["work"] / "fit" / "validation_res" / "Step-2" / "clip0.mp4").exists()
    log = (setup["work"] / "fit" / "train_log.jsonl").read_text().splitlines()
    steps = [json.loads(line) for line in log if '"step"' in line and '"loss"' in line]
    assert [r["step"] for r in steps] == [1]  # the resumed run was not fit()
    assert all(np.isfinite(r["loss"]) for r in steps)


@pytest.mark.parametrize("opt", RESUME_OPTS)
def test_lora_tp_resume_equals_the_uninterrupted_run(setup, opt):
    """Under TP the LoRA factors and their optimizer state are whole on
    every rank: a run resumed after step 1 ends where the uninterrupted run
    ends, weights and optimizer state (CAME's factored statistics, the
    8-bit blocks and their scales) alike."""
    straight, resumed = setup["out"]["resume_optimizers"][opt]
    assert straight.keys() == resumed.keys()
    assert any(k.startswith("opt.") and v.size > 1 for k, v in straight.items())
    for k, v in straight.items():
        np.testing.assert_array_equal(resumed[k], v, err_msg=k)


@pytest.fixture(scope="module")
def opt_shards(tmp_path_factory):
    """``torch_parallel_ranks.optimizer_shards`` on two gloo ranks."""
    work = tmp_path_factory.mktemp("optshards")
    rng = np.random.default_rng(11)
    inputs = dict(
        params=[rng.normal(size=s).astype(np.float32) for s in OPT_SHAPES],
        grads=[[rng.normal(size=s).astype(np.float32) for s in OPT_SHAPES] for _ in range(2)],
        opts=["adamw"] + WHOLE_STAT_OPTS, layouts=OPT_LAYOUTS)
    ranks.dump(inputs, work / "in.pkl")
    ranks.spawn(ranks.optimizer_shards, 2, work, str(work / "in.pkl"), str(work / "out.pkl"))
    jax_ref = {name: _jax_two_steps(name, inputs["params"], inputs["grads"])
               for name in inputs["opts"]}
    return inputs, ranks.load(work / "out.pkl"), jax_ref


def _jax_two_steps(name, params, grads):
    """The JAX package's optimizer for two steps on the whole tensors: its
    parameters, its state, and (low-bit) the values the port's one-device
    run encodes at step 2, for ``_check_codes``' ties."""
    opt = joptim.make_optimizer(name, joptim.make_lr_schedule(OPT_LR), max_grad_norm=None)
    p = [jnp.asarray(x) for x in params]
    state = opt.init(p)
    for g in grads:
        upd, state = opt.update([jnp.asarray(x) for x in g], state, p)
        p = optax.apply_updates(p, upd)
    pre = None
    if "bit" in name:
        port = make_optimizer(name, make_lr_schedule(OPT_LR), max_grad_norm=None)
        ps = [torch.from_numpy(x.copy()) for x in params]
        port.init(ps)
        port.step(ps, [torch.from_numpy(x) for x in grads[0]])
        pre = _pre_round(port, grads[1], max_norm=None)
    return [np.asarray(x) for x in p], state[0], pre


def _matches_jax(run, opt, ref):
    """One run's whole parameters and (low-bit) codes against JAX's; for
    Prodigy, whose steps move the parameters by its distance estimate
    (1e-6 at the start), also its moments, sums and estimate."""
    (params, state), (p_j, state_j, pre) = run, ref
    tol = PARAM_TOL.get(opt.replace("_", "-"), 1e-6)
    for i, (ours, want) in enumerate(zip(params, p_j)):
        err = np.abs(ours - want).max() / np.abs(want).max()
        assert err <= tol, (opt, i, err)
    if opt == "prodigy":
        for k in ("exp_avg", "exp_avg_sq", "grad_sum"):
            for i, want in enumerate(getattr(state_j, k)):
                want = np.asarray(want)
                err = np.abs(state[f"{k}.{i}"] - want).max() / np.abs(want).max()
                assert err <= tol, (k, i, err)
        for k in ("estim_lr", "numerator_weighted"):
            np.testing.assert_allclose(state[k], np.asarray(getattr(state_j, k)), rtol=tol)
    if pre is not None:
        codes = {k: [torch.from_numpy(state[f"{k}.{i}"].astype(
                     np.float32 if k.endswith("scale") else np.int64))
                     for i in range(len(p_j))]
                 for k in ("m_q", "v_q", "m_scale", "v_scale")}
        _check_codes(opt, codes, state_j, pre)


def _same_run(got, want, opt, exact=True):
    (params, state), (params1, state1) = got, want
    assert state.keys() == state1.keys()
    for a, b in zip(params + list(state.values()), params1 + list(state1.values())):
        assert a.shape == b.shape
        if exact or opt.replace("_", "-") != "prodigy":
            np.testing.assert_array_equal(a, b)
        else:
            np.testing.assert_allclose(a, b, rtol=PRODIGY_REL, atol=0)


@pytest.mark.parametrize("opt", WHOLE_STAT_OPTS)
@pytest.mark.parametrize("mesh", [dict(fsdp=2), dict(tensor_parallel=2)])
def test_whole_tensor_statistics_refused_on_a_sharded_dit(opt, mesh, opt_shards):
    """These optimizers were refused with SFT on a DiT that fsdp or
    tensor_parallel shards (ROADMAP C.7) until their statistics were taken
    over the whole tensor: now ``Args`` accepts them as the JAX package
    does, and two steps on split tensors equal one device's (the factored
    statistics, the RMS clip and the block codes bit for bit; Prodigy within
    rel 1e-6)."""
    kw = dict(model_path="x", optimizer=opt, training_type="sft", **mesh)
    jargs.Args(**kw)
    targs.Args(**kw)
    _, res, jax_ref = opt_shards
    _same_run(res[(opt, next(iter(mesh)))], res[(opt, "one")], opt, exact=False)
    for layout in ("one", next(iter(mesh))):
        _matches_jax(res[(opt, layout)], opt, jax_ref[opt])


@pytest.mark.parametrize("opt", ["adamw"] + WHOLE_STAT_OPTS)
def test_sharded_optimizer_state_resumes_under_any_layout(opt, opt_shards):
    """A step-1 checkpoint (the whole state) of each layout, restored under
    each layout and one device, takes step 2 where one device does, and
    under its own layout bit for bit where the uninterrupted run does; the
    gradient norm of split tensors is the whole model's."""
    inputs, res, jax_ref = opt_shards
    for saved in OPT_LAYOUTS:
        for layout in list(OPT_LAYOUTS) + ["one"]:
            got = res[(opt, f"{saved}->{layout}")]
            _same_run(got, res[(opt, "one")], opt, exact=False)
            _matches_jax(got, opt, jax_ref[opt])
            if layout == saved:
                _same_run(got, res[(opt, layout)], opt)
    ref = float(optax.global_norm([jnp.asarray(g) for g in inputs["grads"][0]]))
    for layout in OPT_LAYOUTS:
        assert res[("norm", layout)] == pytest.approx(ref, rel=1e-6)


def test_tp_plus_fsdp_refused():
    for Args in (targs.Args, jargs.Args):
        with pytest.raises(ValueError, match="tensor_parallel"):
            Args(model_path="x", tensor_parallel=2, fsdp=2)


def test_opt_state_tp_specs_mirror_params():
    """``map_shards`` applies to the state that mirrors a split parameter
    (Adam's moments, CAME's ``m``, the accumulator of ``MultiSteps``); the
    count, whole parameters' state and CAME's whole-tensor statistics pass
    as they are."""
    from dove_tpu_torch.train.optim import MultiSteps

    params = [torch.zeros(4, 6), torch.zeros(3)]
    split = Split(0, (8, 6), Group(None, 2, 0))
    for name, keys in (("adamw", ("mu", "nu")), ("came", ("m",))):
        opt = MultiSteps(make_optimizer(name, make_lr_schedule(1e-3, warmup_steps=0)), 2)
        opt.init(params, [split, None])
        state = opt.state_dict()
        seen = []
        out = opt.map_shards(state, lambda sp, t: seen.append(t.shape) or "gathered")
        assert out["acc"] == ["gathered", state["acc"][1]]
        for k in keys:
            assert out["inner"][k] == ["gathered", state["inner"][k][1]]
        for k in set(state["inner"]) - set(keys):
            assert out["inner"][k] is state["inner"][k]
        assert len(seen) == 1 + len(keys) and out["mini_step"] == state["mini_step"]
    came = make_optimizer("came", make_lr_schedule(1e-3, warmup_steps=0))
    came.init(params, [split, None])
    assert came.vr[0].shape == (8,) and came.vc[0].shape == (6,)  # the whole tensor's


def test_two_process_train_cli(setup, tmp_path):
    """``python -m dove_tpu_torch.train --multihost true`` as two processes
    joined through DOVE_COORDINATOR: data=2, each loads one clip a step."""
    out = tmp_path / "out"
    argv = [sys.executable, "-m", "dove_tpu_torch.train", "--multihost", "true",
            "--device", "cpu", "--model_path", str(setup["ckpt"]), "--base_preset", "tiny",
            "--training_type", "lora", "--rank", "4", "--lora_alpha", "4",
            "--output_dir", str(out), "--data_root", str(setup["data"]),
            "--video_column", str(setup["data"] / "videos.txt"),
            "--degradation_config", str(setup["data"] / "degradation.yaml"),
            "--train_resolution", "5x32x32", "--batch_size", "2", "--train_steps", "2",
            "--checkpointing_steps", "2", "--mixed_precision", "no", "--num_workers", "0",
            "--learning_rate", "1e-3", "--lr_warmup_steps", "0", "--stastic_frequency", "0",
            "--seed", "7"]
    procs = []
    for pid in range(2):
        env = dict(os.environ, DOVE_COORDINATOR=f"file://{tmp_path}/rendezvous",
                   DOVE_NUM_PROCESSES="2", DOVE_PROCESS_ID=str(pid), OMP_NUM_THREADS="1",
                   PYTHONPATH=str(REPO))
        procs.append(subprocess.Popen(argv, cwd=REPO, env=env, stdout=subprocess.PIPE,
                                      stderr=subprocess.STDOUT, text=True))
    logs = [p.communicate(timeout=240)[0] for p in procs]
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-3000:]
    pat = re.compile(r"'step': (\d+), 'loss': ([-0-9.e]+)")
    losses = [[(int(s), float(v)) for s, v in pat.findall(log)] for log in logs]
    assert [s for s, _ in losses[0]] == [1, 2]
    assert losses[0] == losses[1]  # the global mean, on every rank
    recs = [json.loads(line) for line in (out / "train_log.jsonl").read_text().splitlines()]
    assert [r["step"] for r in recs if "loss" in r] == [1, 2]  # rank 0 alone writes
    assert [r["loss"] for r in recs if "loss" in r] == [v for _, v in losses[0]]

    from dove_tpu_torch.train.trainer import DOVES1Trainer

    args = targs.Args.parse_args(argv[argv.index("--model_path"):])
    resumed = DOVES1Trainer(args, device="cpu")
    resumed.load_components()
    resumed.prepare_optimizer(2)
    resumed.maybe_resume()
    assert resumed.global_step == 2
    saved = torch.load(out / "checkpoint-2" / "state.pt", weights_only=True)
    for t, d in resumed.lora_params.items():
        for ab, x in d.items():
            torch.testing.assert_close(x.detach(), saved["trainable"][t][ab], rtol=0, atol=0)
