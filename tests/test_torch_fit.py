"""``Trainer.fit``, ``validate`` and ``python -m dove_tpu_torch.train`` against
the JAX package's trainer and ``scripts/train.py``, on tiny_test().

Both trainers read one diffusers-layout checkpoint this test writes (the JAX
package's seeded weights) and the same files: clips that ``_write_clip``
makes, ``TINY_DEGRADATION``. Each side builds its own dataset and loader from
the same argv (the port's in two spawned worker processes, the JAX one in two
threads), so the batches agree to the data tests' bar. The frameworks' RNGs
cannot match, so, as the stage-2 training tests do, both sides take the
posterior mean instead of a sample, and the port's LoRA starts from the JAX
package's init. Two steps of ``dove-s1`` LoRA, of its ``is_latent`` route
and of ``dove-s2`` SFT on ``real-sr-image-video`` give the same losses within
LOSS_RTOL and the same train_log.jsonl keys (stage 2 in
tests/test_torch_fit_s2.py, which takes its fixtures from here); a run
resumed from checkpoint-1 repeats step 2. ``validate`` gives JAX's summary on a video file and a frame
folder. Every flag of scripts/train_s1.sh and train_s2.sh parses to the JAX
package's ``Args``.
"""

from __future__ import annotations

import dataclasses
import json
import shutil
import subprocess
import sys
from pathlib import Path

import cv2
import jax
import numpy as np
import pytest
import torch

import dove_tpu.pipeline as jpipeline
import dove_tpu_torch.pipeline as tpipeline
from dove_tpu import config as jcfg
from dove_tpu.models import dit as jdit
from dove_tpu.models import vae as jvae
from dove_tpu.train import args as jargs
from dove_tpu.train import lora as jlora
from dove_tpu.train import trainer as jtrainer
from dove_tpu_torch import safetensors_io
from dove_tpu_torch import weights as tweights
from dove_tpu_torch.models import vae as tvae
from dove_tpu_torch.train import args as targs
from dove_tpu_torch.train import trainer as ttrainer
from dove_tpu_torch.train.__main__ import main as train_main
from test_trainer import TINY_DEGRADATION, _write_clip
from torch_threads import two_torch_threads  # noqa: F401 (autouse)

REPO = Path(__file__).resolve().parents[1]
LOSS_RTOL = 1e-4  # the batches differ by the data ops' float rounding
PSNR_TOL = 1e-4  # dB
SSIM_TOL = 1e-5
RANK = 4

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


@pytest.fixture(scope="module")
def checkpoint(tmp_path_factory):
    """A diffusers-layout tiny_test() checkpoint of the JAX package's init."""
    root = tmp_path_factory.mktemp("ckpt")
    cfg = jcfg.tiny_test()
    dit_tree = jax.tree.map(np.asarray, jdit.init_dit_params(jax.random.PRNGKey(0), cfg.dit))
    vae_tree = jax.tree.map(np.asarray, jvae.init_vae_params(jax.random.PRNGKey(1), cfg.vae))
    for sub, tensors, conf in (
            ("transformer", tweights.jax_dit_to_diffusers(dit_tree), cfg.dit),
            ("vae", tweights.jax_vae_to_diffusers(vae_tree), cfg.vae)):
        (root / sub).mkdir()
        safetensors_io.save_file(tensors, root / sub / "diffusion_pytorch_model.safetensors")
        (root / sub / "config.json").write_text(json.dumps(dataclasses.asdict(conf)))
    (root / "scheduler").mkdir()
    (root / "scheduler" / "scheduler_config.json").write_text(
        json.dumps(dataclasses.asdict(cfg.scheduler)))
    return root


def _data_dir(root: Path) -> Path:
    root.mkdir(parents=True)
    (root / "videos").mkdir()
    for i in range(2):
        _write_clip(root / "videos" / f"clip{i}.mp4")
    (root / "videos.txt").write_text("videos/clip0.mp4\nvideos/clip1.mp4\n")
    (root / "images").mkdir()
    img = np.random.default_rng(1).integers(0, 255, (64, 64, 3), np.uint8)
    cv2.imwrite(str(root / "images" / "img0.png"), img)
    (root / "images.txt").write_text("images/img0.png\n")
    (root / "degradation.yaml").write_text(TINY_DEGRADATION)
    return root


def _argv(checkpoint: Path, data: Path, out: Path, **over) -> list[str]:
    """Two steps of batch 2 from 2 clips: one batch an epoch, two epochs."""
    kw = dict(
        model_path=checkpoint, model_name="dove-s1", training_type="lora",
        rank=RANK, lora_alpha=RANK, output_dir=out, data_root=data,
        video_column=data / "videos.txt", degradation_config=data / "degradation.yaml",
        train_resolution="5x32x32", batch_size=2, train_steps=2,
        checkpointing_steps=1, mixed_precision="no", num_workers=2,
        learning_rate=1e-3, lr_warmup_steps=0, lr_scheduler="constant",
        stastic_frequency=0, seed=42,
    )
    kw.update(over)
    return [s for k, v in kw.items() for s in (f"--{k}", str(v))]


@pytest.fixture
def same_start(monkeypatch):
    """Both sides sample the posterior mean; the port's LoRA starts from the
    JAX package's init."""
    j_sample, t_sample = jvae.sample_latent, ttrainer.sample_latent
    monkeypatch.setattr(jvae, "sample_latent", lambda m, rng, sf: j_sample(m, None, sf))
    monkeypatch.setattr(ttrainer, "sample_latent", lambda m, gen, sf: t_sample(m, None, sf))

    def lora_init(cfg, rank, seed, device):
        tree = jlora.init_lora_params(jax.random.PRNGKey(seed), jcfg.tiny_test().dit,
                                      rank=rank)
        return tweights.from_jax_lora(jax.tree.map(np.asarray, tree))

    monkeypatch.setattr(ttrainer, "init_lora_params", lora_init)


def _log(out: Path) -> list[dict]:
    return [json.loads(ln) for ln in (out / "train_log.jsonl").read_text().splitlines()]


def _fit_both(checkpoint, tmp_path, **over) -> tuple[list[dict], list[dict], Path]:
    """The JAX trainer's fit and the port's CLI on the same argv, each from a
    data directory of its own (the latent cache is written into it)."""
    logs = []
    for name in ("jax", "port"):
        data = _data_dir(tmp_path / f"data_{name}")
        argv = _argv(checkpoint, data, tmp_path / name,
                     **{k: v(data) if callable(v) else v for k, v in over.items()})
        if name == "jax":
            args = jargs.Args.parse_args(argv)
            jtrainer.get_model_cls(args.model_name, args.training_type)(args).fit()
        else:
            train_main(argv + ["--device", "cpu"])
        logs.append(_log(tmp_path / name))
    return logs[0], logs[1], tmp_path / "port"


def _assert_logs_match(ours: list[dict], ref: list[dict], steps: int = 2) -> None:
    assert [sorted(r) for r in ours] == [sorted(r) for r in ref]
    assert ours[0] == ref[0]  # the video-compression backend
    steps_ours = [r for r in ours if "loss" in r]
    steps_ref = [r for r in ref if "loss" in r]
    assert [r["step"] for r in steps_ours] == list(range(1, steps + 1))
    for a, b in zip(steps_ours, steps_ref):
        for key in b:
            if key.startswith("loss"):
                np.testing.assert_allclose(a[key], b[key], rtol=LOSS_RTOL, err_msg=key)
        np.testing.assert_allclose(a["grad_norm"], b["grad_norm"], rtol=1e-3)


def test_fit_matches_jax_and_resumes(checkpoint, tmp_path, same_start):
    ref, ours, out = _fit_both(checkpoint, tmp_path)
    _assert_logs_match(ours, ref)
    assert ref[1]["loss"] != ref[2]["loss"]  # step 2 saw the update of step 1
    assert sorted(p.name for p in out.glob("checkpoint-*")) == ["checkpoint-1",
                                                                 "checkpoint-2"]
    # resumed from checkpoint-1 (epoch 1, the same batch), step 2 repeats
    resumed = tmp_path / "resumed"
    resumed.mkdir()
    shutil.copytree(out / "checkpoint-1", resumed / "checkpoint-1")
    data = tmp_path / "data_port"
    tr = train_main(_argv(checkpoint, data, resumed) + ["--device", "cpu"])
    assert tr.global_step == 2 and len(tr.data_wait_s) == 1
    again = [r for r in _log(resumed) if "loss" in r]
    assert [r["step"] for r in again] == [2]
    first = next(r for r in _log(out) if r.get("step") == 2)
    np.testing.assert_allclose(again[0]["loss"], first["loss"], rtol=1e-6)


def test_fit_is_latent_matches_jax(checkpoint, tmp_path, same_start):
    ref, ours, _ = _fit_both(checkpoint, tmp_path, is_latent="true")
    _assert_logs_match(ours, ref)
    files = {name: sorted(str(p.relative_to(tmp_path / f"data_{name}"))
                          for p in (tmp_path / f"data_{name}" / "cache").rglob("*"))
             for name in ("jax", "port")}
    assert files["port"] == files["jax"]
    assert "cache/video_latent/hq/dove-s1/5x32x32/clip0.safetensors" in files["port"]


# ---------------------------------------------------------------------------
# validate
# ---------------------------------------------------------------------------

def _validation_dirs(root: Path) -> tuple[Path, Path]:
    """One video file and one frame folder of LQ clips, with 4x GT."""
    lq, gt = root / "lq", root / "gt"
    _write_clip_sized(lq / "a.mp4", 5, 16, 16, seed=0)
    _write_clip_sized(gt / "a.mp4", 5, 64, 64, seed=1)
    rng = np.random.default_rng(2)
    for d, (h, w) in ((lq / "b", (16, 24)), (gt / "b", (64, 96))):
        d.mkdir(parents=True)
        for i in range(5):
            cv2.imwrite(str(d / f"{i:03d}.png"), rng.integers(0, 255, (h, w, 3), np.uint8))
    return lq, gt


def _write_clip_sized(path: Path, frames: int, h: int, w: int, seed: int) -> None:
    path.parent.mkdir(parents=True, exist_ok=True)
    writer = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*"mp4v"), 8, (w, h))
    rng = np.random.default_rng(seed)
    for _ in range(frames):
        writer.write(rng.integers(0, 255, (h, w, 3), np.uint8))
    writer.release()


@pytest.fixture
def mean_posterior(monkeypatch):
    """Each package's DovePipeline takes the posterior mean."""
    for mod in (jpipeline, tpipeline):
        cls = mod.DovePipeline
        monkeypatch.setattr(mod, "DovePipeline", lambda cls=cls, **kw: cls(
            **{**kw, "sample_posterior": False}))


def _trainers(checkpoint, tmp_path, lq, gt, lora_tree):
    argv = _argv(checkpoint, tmp_path, tmp_path / "out", validation_dir=lq,
                 validation_ref_videos=gt, eval_metric_list="psnr,ssim,lpips")
    tj = jtrainer.DOVES1Trainer(jargs.Args.parse_args(argv))
    tj.load_components()
    tj.lora_params = jax.tree.map(jax.numpy.asarray, lora_tree)
    tt = ttrainer.DOVES1Trainer(targs.Args.parse_args(argv), device="cpu")
    tt.load_components()
    tt.lora_params = tweights.from_jax_lora(lora_tree)
    return tj, tt


def test_validate_matches_jax(checkpoint, tmp_path, mean_posterior, monkeypatch):
    """psnr and ssim on a video file and a frame folder with a LoRA whose B is
    off zero; lpips, whose weights are missing, is skipped with a warning on
    both sides. The artifacts are mp4s here; without OpenCV the frame folder
    is written as PNGs and the record says so."""
    monkeypatch.delenv("DOVE_LPIPS_WEIGHTS", raising=False)
    lq, gt = _validation_dirs(tmp_path / "val")
    rng = np.random.default_rng(3)
    tree = jax.tree.map(np.asarray, jlora.init_lora_params(
        jax.random.PRNGKey(2), jcfg.tiny_test().dit, rank=RANK))
    for ab in tree.values():
        ab["B"] = 0.2 * rng.standard_normal(ab["B"].shape).astype(np.float32)
    tj, tt = _trainers(checkpoint, tmp_path, lq, gt, tree)
    ref = tj.validate(3)
    ours = tt.validate(3)
    assert sorted(ours) == sorted(ref) == ["psnr", "ssim"]
    assert abs(ours["psnr"] - ref["psnr"]) <= PSNR_TOL
    assert abs(ours["ssim"] - ref["ssim"]) <= SSIM_TOL
    step_dir = tmp_path / "out" / "validation_res" / "Step-3"
    assert sorted(p.name for p in step_dir.iterdir()) == ["a.mp4", "b.mp4"]

    # without OpenCV (the card): the frame folder alone, written as PNGs
    only_frames = tmp_path / "val" / "frames_only"
    shutil.copytree(lq / "b", only_frames / "b")
    tt.args.validation_dir = only_frames
    tt._log_file = open(tmp_path / "log.jsonl", "w")
    monkeypatch.setitem(sys.modules, "cv2", None)
    summary = tt.validate(4)
    tt._log_file.close()
    rec = json.loads((tmp_path / "log.jsonl").read_text())
    assert rec == {"step": 4, "validation": summary, "artifact": "png"}
    pngs = sorted(p.name for p in (tmp_path / "out" / "validation_res" / "Step-4" / "b")
                  .iterdir())
    assert pngs == [f"{i:03d}.png" for i in range(5)]


def test_train_step_after_validate_equals_one_without(checkpoint, tmp_path):
    """validate leaves the trainer as it found it: a step after it equals a
    step of a twin trainer that never validated."""
    lq, gt = _validation_dirs(tmp_path / "val")
    rng = np.random.default_rng(4)
    batch = {"hq_video": rng.uniform(-1, 1, (2, 5, 32, 32, 3)).astype(np.float32),
             "lq_video": rng.uniform(-1, 1, (2, 5, 32, 32, 3)).astype(np.float32)}
    tree = jax.tree.map(np.asarray, jlora.init_lora_params(
        jax.random.PRNGKey(2), jcfg.tiny_test().dit, rank=RANK))
    runs = []
    for validate in (True, False):
        _, tt = _trainers(checkpoint, tmp_path / str(validate), lq, gt, tree)
        tt.prepare_optimizer(2)
        tvae.set_pallas_conv(False)
        if validate:
            tt.dit.train()  # a mode validate's pipeline changes
            modes = [m.training for m in (tt.dit, tt.vae)]
            assert set(tt.validate(1)) == {"psnr", "ssim"}
            assert [m.training for m in (tt.dit, tt.vae)] == modes
            assert torch.is_grad_enabled() and tvae._HAND_BF16_CONV is False
        else:
            tt.dit.train()
        loss, _, gnorm = tt.train_step(tt.device_batch(batch))
        runs.append((float(loss), float(gnorm),
                     [t.detach().clone() for t in tt.trainable_tensors()]))
    (la, ga, ta), (lb, gb, tb) = runs
    assert la == lb and ga == gb
    assert all(torch.equal(a, b) for a, b in zip(ta, tb))


# ---------------------------------------------------------------------------
# The CLI
# ---------------------------------------------------------------------------

def _script_argv(name: str) -> list[str]:
    """The argv that scripts/<name> hands scripts/train.py, as bash expands it
    with the environment's defaults."""
    text = (REPO / "scripts" / name).read_text().replace(
        "python scripts/train.py", "printf '%s\\n'")
    res = subprocess.run(["bash", "-c", text], capture_output=True, text=True,
                         timeout=60, env={"PATH": "/usr/bin:/bin"}, check=True)
    return res.stdout.splitlines()


@pytest.mark.parametrize("script", ["train_s1.sh", "train_s2.sh"])
def test_train_script_flags_parse_as_jax(script):
    argv = _script_argv(script)
    assert "--do_validation" in argv or script == "train_s2.sh"
    ref = jargs.Args.parse_args(argv).model_dump()
    ours = targs.Args.parse_args(argv).model_dump()
    assert list(ours) == list(ref)
    for name, want in ref.items():
        got = ours[name]
        assert (str(got) if isinstance(want, Path) else got) == (
            str(want) if isinstance(want, Path) else want), name
    ns = targs.Args.parser().parse_args(argv)
    assert targs.Args.from_namespace(ns).model_dump() == ours


def test_train_cli_help_and_refusals(tmp_path):
    res = subprocess.run([sys.executable, "-m", "dove_tpu_torch.train", "--help"],
                         cwd=REPO, capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    for flag in ("--device", "--do_validation", "--is_latent", "--validation_dir"):
        assert flag in res.stdout
    # what the JAX package refuses, the port refuses: tensor_parallel beside
    # fsdp, and optical flow without RAFT's weights (before any model is
    # built); --multihost runs (2 processes: tests/test_torch_parallel_train.py)
    with pytest.raises(ValueError, match="tensor_parallel and fsdp"):
        train_main(["--model_path", "m", "--tensor_parallel", "2", "--fsdp", "2",
                    "--device", "cpu"])
    with pytest.raises(FileNotFoundError, match="raft_weights"):
        train_main(["--model_path", "m", "--use_optical_flow", "true", "--device", "cpu",
                    "--output_dir", str(tmp_path / "flow")])
    # the options A.8 ported parse as the JAX package's CLI parses them (runs:
    # tests/test_torch_accumulation.py)
    argv = ["--model_path", "m", "--report_to", "wandb", "--optimizer", "came",
            "--gradient_accumulation_steps", "2"]
    ours = targs.Args.parse_args(argv).model_dump()
    ref = jargs.Args.parse_args(argv).model_dump()
    for name in ("report_to", "optimizer", "gradient_accumulation_steps"):
        assert ours[name] == ref[name]
