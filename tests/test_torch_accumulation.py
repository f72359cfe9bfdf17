"""Gradient accumulation and the trackers of the port's trainer, against the
JAX package (fp32 on the CPU).

``optim.MultiSteps`` against ``optax.MultiSteps(make_optimizer("adamw"), 2)``
over five micro-steps, the clip acting on the mean; the port's training
entry point with k = 2, ``--report_to all``, resumed at micro-step 3 (which
k does not divide, so the checkpoint carries half a window), against the
straight run, bit for bit; and ``train/tracking.py``'s offline wandb run
against ``dove_tpu``'s for the same calls.
"""

from __future__ import annotations

import json
import shutil
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from dove_tpu.train import optim as joptim
from dove_tpu.train import tracking as jtracking
from dove_tpu_torch.train import checkpointing as tckpt
from dove_tpu_torch.train import optim as toptim
from dove_tpu_torch.train import tracking as ttracking
from dove_tpu_torch.train.__main__ import main as train_main
from torch_threads import two_torch_threads  # noqa: F401 (autouse)

OPT_TOL = 1e-6  # fp32 against fp32, of the leaf's largest value
SHAPES = [(3, 5), (4,), (2, 3, 2)]
MAX_NORM = 2.0


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """This file's small torch work in one thread: beside the suite's other
    workers a full thread pool oversubscribes the cores (the int8 VAE
    modes' plain convolutions then ran tens of times slower)."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def _micro_grads(seed: int, n: int) -> list[list[np.ndarray]]:
    """Micro-gradients over MAX_NORM whose window means lie under it: each
    window's two are a shared direction with opposite signs, plus noise."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        if i % 2 == 0:
            base = [rng.standard_normal(s).astype(np.float32) for s in SHAPES]
        sign = -0.6 if i % 2 else 1.0
        out.append([(sign * (0.8 + 0.2 * i) * b + 0.05 * rng.standard_normal(b.shape))
                    .astype(np.float32) for b in base])
    return out


def _run_port(opt, params, grads):
    p = [torch.from_numpy(x.copy()) for x in params]
    opt.init(p)
    history = []
    for g in grads:
        opt.step(p, [torch.from_numpy(x) for x in g])
        history.append([x.clone().numpy() for x in p])
    return history


@pytest.mark.parametrize("name", ["adamw", "came"])
def test_multisteps_matches_optax(name):
    rng = np.random.default_rng(3)
    params = [rng.standard_normal(s).astype(np.float32) for s in SHAPES]
    grads = _micro_grads(4, 5)
    kw = dict(betas=(0.9, 0.95), eps=1e-8, weight_decay=0.05, max_grad_norm=MAX_NORM)
    sched_j = joptim.make_lr_schedule(1e-2, warmup_steps=1)
    opt_j = optax.MultiSteps(joptim.make_optimizer(name, sched_j, **kw), 2)
    p_j = [jnp.asarray(x) for x in params]
    state = opt_j.init(p_j)
    sched_t = toptim.make_lr_schedule(1e-2, warmup_steps=1)
    opt = toptim.MultiSteps(toptim.make_optimizer(name, sched_t, **kw), 2)
    ours = _run_port(opt, params, grads)
    means_clip = []
    for k, g in enumerate(grads):
        upd, state = opt_j.update([jnp.asarray(x) for x in g], state, p_j)
        p_j = optax.apply_updates(p_j, upd)
        for a, b in zip(ours[k], p_j):
            b = np.asarray(b)
            assert np.abs(a - b).max() <= OPT_TOL * np.abs(b).max(), (k, name)
        if k % 2:  # the mean this window applied
            mean = [(x + y) / 2 for x, y in zip(grads[k - 1], g)]
            means_clip.append(float(np.sqrt(sum((m ** 2).sum() for m in mean))) >= MAX_NORM)
    assert opt.count == 2 and int(state.gradient_step) == 2
    assert opt.mini_step == 1 and int(state.mini_step) == 1
    acc_j = [np.asarray(a) for a in state.acc_grads]
    for a, b in zip(opt.acc, acc_j):
        np.testing.assert_allclose(a.numpy(), b, rtol=OPT_TOL, atol=1e-7)
    # every micro-gradient is over the bar, no mean is: clipping each
    # micro-gradient would be another result
    norms = [float(np.sqrt(sum((x ** 2).sum() for x in g))) for g in grads[:4]]
    assert all(n >= MAX_NORM for n in norms[1:]) and not any(means_clip)
    clip_each = toptim.MultiSteps(toptim.make_optimizer(name, sched_t, **kw), 2)
    clipped_grads = [[x * min(1.0, MAX_NORM / n) for x in g] for g, n in zip(grads, norms)]
    other = _run_port(clip_each, params, clipped_grads[:4])
    assert max(np.abs(a - b).max() for a, b in zip(other[3], ours[3])) > 1e-4


def _image_data(root: Path) -> list[str]:
    """Two PNG images as one-frame clips and a blur + 4x downscale config."""
    from PIL import Image

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
    return ["--data_root", str(root), "--video_column", str(root / "list.txt"),
            "--degradation_config", str(root / "deg.yaml")]


def _argv(data: list[str], out: Path, optimizer: str) -> list[str]:
    return data + [
        "--model_path", str(out.parent / "nonexistent_model"), "--model_name", "dove-s1",
        "--base_preset", "tiny", "--training_type", "lora", "--rank", "4",
        "--lora_alpha", "2", "--output_dir", str(out), "--train_resolution", "5x32x32",
        "--batch_size", "2", "--train_steps", "5", "--checkpointing_steps", "3",
        "--gradient_accumulation_steps", "2", "--report_to", "all",
        "--optimizer", optimizer, "--mixed_precision", "no", "--num_workers", "0",
        "--learning_rate", "1e-2", "--lr_scheduler", "constant", "--lr_warmup_steps", "0",
        "--max_grad_norm", "1.0", "--stastic_frequency", "0", "--device", "cpu"]


def _state(path: Path) -> dict:
    return torch.load(path / tckpt.STATE_FILE, map_location="cpu", weights_only=True)


def _assert_equal(a, b, where="state") -> None:
    if isinstance(a, dict):
        assert set(a) == set(b), where
        for k in a:
            _assert_equal(a[k], b[k], f"{where}.{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_equal(x, y, f"{where}[{i}]")
    elif isinstance(a, torch.Tensor):
        assert torch.equal(a, b), where
    else:
        assert a == b, where


def _log(out: Path) -> list[dict]:
    return [json.loads(x) for x in (out / "train_log.jsonl").read_text().splitlines()]


@pytest.mark.parametrize("optimizer", ["adamw", "adamw-4bit"])
def test_resume_inside_a_window_repeats_the_straight_run(tmp_path, optimizer):
    """Five micro-steps with k = 2 straight, and the same run resumed from
    checkpoint-3 (one micro-gradient in the accumulator): the same losses at
    steps 4 and 5 and the same final state, bit for bit. The trackers of
    --report_to all wrote their files."""
    data = _image_data(tmp_path / "data")
    straight, resumed = tmp_path / "straight", tmp_path / "resumed"
    tr = train_main(_argv(data, straight, optimizer))
    assert tr.global_step == 5 and tr.optimizer.count == 2
    assert tr.optimizer.mini_step == 1
    ckpt3 = _state(straight / "checkpoint-3")
    assert ckpt3["opt_state"]["mini_step"] == 1
    assert any(bool(a.any()) for a in ckpt3["opt_state"]["acc"])
    resumed.mkdir()
    shutil.copytree(straight / "checkpoint-3", resumed / "checkpoint-3")
    tr2 = train_main(_argv(data, resumed, optimizer))
    assert tr2.global_step == 5
    _assert_equal(_state(straight / "checkpoint-5"), _state(resumed / "checkpoint-5"))
    first = {r["step"]: r["loss"] for r in _log(straight) if "loss" in r}
    second = {r["step"]: r["loss"] for r in _log(resumed) if "loss" in r}
    assert sorted(second) == [4, 5] and all(first[s] == second[s] for s in (4, 5))
    # the lr schedule and the inner count moved only on the applied steps
    assert _state(straight / "checkpoint-5")["opt_state"]["inner"]["count"] == 2
    # the trackers
    runs = list((straight / "wandb").glob("offline-run-*"))
    assert len(runs) == 1 and (runs[0] / "run-finished").exists()
    hist = [json.loads(x) for x in
            (runs[0] / "files" / "wandb-history.jsonl").read_text().splitlines()]
    assert [h["_step"] for h in hist] == [1, 2, 3, 4, 5]
    assert all(h["train/loss"] == first[h["_step"]] for h in hist)
    assert list((straight / "tb" / "VSR").glob("events.out.tfevents.*"))


def _tree(files: Path) -> list[str]:
    """The run's files, tfevents names cut to their prefix (host and time)."""
    out = []
    for p in sorted(files.rglob("*")):
        rel = p.relative_to(files).as_posix()
        out.append("events.out.tfevents" if rel.startswith("events.out.tfevents") else rel)
    return sorted(out)


def test_wandb_offline_run_matches_jax(tmp_path):
    clip = tmp_path / "clip.mp4"
    clip.write_bytes(b"not really a video, bytes to copy")
    config = {"learning_rate": 1e-4, "output_dir": "out", "report_to": "wandb",
              "train_resolution": [25, 320, 640], "note": "a: b", "flag": True,
              "none": None}
    runs = {}
    for name, mod in (("jax", jtracking), ("port", ttracking)):
        run = mod.WandbOfflineRun(tmp_path / name, project="VSR", config=config,
                                  run_id="0000abcd")
        run.log({"train/loss": 0.5, "train/grad_norm": 2}, 1)
        run.log({"train/loss": 0.25, "train/lr": 1e-4}, 2)
        run.log_video("validation/clip", clip, 2)
        run.log({"validation/psnr": 31.5}, 2)
        run.finish()
        runs[name] = run
    fj, fp = runs["jax"].files, runs["port"].files
    assert _tree(fj) == _tree(fp)
    assert "events.out.tfevents" in _tree(fp)
    for rel in ("config.yaml", "media/videos/validation_clip/clip_step2.mp4"):
        assert (fj / rel).read_bytes() == (fp / rel).read_bytes(), rel

    def records(files: Path, name: str) -> list[dict]:
        out = []
        for line in (files / name).read_text().splitlines():
            rec = json.loads(line)
            rec.pop("_runtime"), rec.pop("_timestamp")
            out.append(rec)
        return out

    assert records(fj, "wandb-history.jsonl") == records(fp, "wandb-history.jsonl")
    assert records(fj, "output.log") == records(fp, "output.log")
    sj = json.loads((fj / "wandb-summary.json").read_text())
    sp = json.loads((fp / "wandb-summary.json").read_text())
    for s in (sj, sp):
        s.pop("_runtime"), s.pop("_timestamp")
    assert sj == sp
    mj = json.loads((fj / "wandb-metadata.json").read_text())
    mp = json.loads((fp / "wandb-metadata.json").read_text())
    mj.pop("startedAt"), mp.pop("startedAt")
    assert mj == mp
