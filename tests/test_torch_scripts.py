"""The port's script counterparts against the JAX package's scripts.

``python -m dove_tpu_torch.prepare_sft_ckpt`` on a port checkpoint and
``scripts/prepare_sft_ckpt.py`` on an orbax checkpoint of the same trained
tensors (tiny_test()'s seeded DiT under SFT, a seeded LoRA tree) write the
same files: the same safetensors keys with equal tensors, the same
``config.json``, the base folder's components copied alike.
``python -m dove_tpu_torch.convert_frames_to_video`` and
``scripts/convert_frames_to_video.py`` on the same PNG folders write mp4s
that decode to equal frames, and the same manifest. Both scripts run in
this process, on the CPU.
"""

from __future__ import annotations

import dataclasses
import filecmp
import importlib
import json
import sys
from pathlib import Path

import cv2
import jax
import numpy as np
import pytest
import torch

from dove_tpu import config as jcfg
from dove_tpu.models import dit as jdit
from dove_tpu.train import checkpointing as jckpt
from dove_tpu.train.lora import init_lora_params
from dove_tpu_torch import safetensors_io
from dove_tpu_torch import weights as tweights
from dove_tpu_torch.train import checkpointing as tckpt
from torch_threads import two_torch_threads  # noqa: F401 (autouse)

REPO = Path(__file__).resolve().parents[1]


def _script(name: str):
    sys.path.insert(0, str(REPO / "scripts"))
    try:
        return importlib.import_module(name)
    finally:
        sys.path.remove(str(REPO / "scripts"))


def _run_script(monkeypatch, name: str, argv: list[str]) -> None:
    monkeypatch.setattr(sys, "argv", [f"{name}.py", *argv])
    _script(name).main()


def _base_model(root: Path, cfg) -> Path:
    base = root / "base"
    for sub, name, conf in (("transformer", "config.json", cfg.dit),
                            ("vae", "config.json", cfg.vae),
                            ("scheduler", "scheduler_config.json", cfg.scheduler)):
        (base / sub).mkdir(parents=True)
        (base / sub / name).write_text(json.dumps(dataclasses.asdict(conf)))
    for sub in ("vae", "tokenizer", "text_encoder"):
        (base / sub).mkdir(exist_ok=True)
        (base / sub / "weights.bin").write_bytes(sub.encode() * 3)
    (base / "model_index.json").write_text('{"_class_name": "CogVideoXPipeline"}')
    return base


def _same_tree(a: Path, b: Path) -> None:
    files_a = sorted(p.relative_to(a) for p in a.rglob("*") if p.is_file())
    assert files_a == sorted(p.relative_to(b) for p in b.rglob("*") if p.is_file())
    for rel in files_a:
        if rel.suffix == ".safetensors":
            ta, tb = safetensors_io.load_file(a / rel), safetensors_io.load_file(b / rel)
            assert ta.keys() == tb.keys(), rel
            for k in ta:
                assert ta[k].dtype == tb[k].dtype and torch.equal(ta[k], tb[k]), (rel, k)
        else:
            assert filecmp.cmp(a / rel, b / rel, shallow=False), rel


@pytest.mark.parametrize("training_type", ["sft", "lora"])
def test_prepare_sft_ckpt_matches_the_jax_script(tmp_path, monkeypatch, training_type):
    cfg = jcfg.tiny_test()
    if training_type == "sft":
        tree = jax.tree.map(np.asarray, jdit.init_dit_params(jax.random.PRNGKey(0), cfg.dit))
        ours = {k: torch.from_numpy(np.array(v))
                for k, v in tweights.jax_dit_to_diffusers(tree).items()}
    else:
        tree = jax.tree.map(np.asarray, init_lora_params(jax.random.PRNGKey(2), cfg.dit,
                                                         rank=4))
        ours = {t: {ab: torch.from_numpy(np.array(x)) for ab, x in d.items()}
                for t, d in tree.items()}
    opt = {"count": np.int32(5)}
    for step in (3, 5):  # the newest is taken without --step
        jckpt.save_checkpoint(tmp_path / "jax_run", step, {"trainable": tree, "opt_state": opt})
        tckpt.save_checkpoint(tmp_path / "port_run", step,
                              {"trainable": ours, "opt_state": {"count": 5}})
    base = _base_model(tmp_path, cfg)
    flags = ["--training_type", training_type, "--base_model", str(base),
             "--base_preset", "tiny", "--rank", "4"]
    _run_script(monkeypatch, "prepare_sft_ckpt",
                ["--run_dir", str(tmp_path / "jax_run"), "--output_dir",
                 str(tmp_path / "ref"), *flags])
    from dove_tpu_torch import prepare_sft_ckpt

    prepare_sft_ckpt.main(["--run_dir", str(tmp_path / "port_run"), "--output_dir",
                           str(tmp_path / "ours"), *flags])
    _same_tree(tmp_path / "ours", tmp_path / "ref")
    names = {p.name for p in (tmp_path / "ours").iterdir()}
    if training_type == "sft":
        assert names == {"transformer", "vae", "scheduler", "tokenizer", "text_encoder",
                         "model_index.json"}
        # the written transformer loads into the port's DiT
        from dove_tpu_torch import config as tcfg

        tweights.load_dit(tmp_path / "ours", tcfg.tiny_test().dit, torch.float32, "cpu")
    else:
        assert names == {"pytorch_lora_weights.safetensors"}
    prepare_sft_ckpt.main(["--run_dir", str(tmp_path / "port_run"), "--step", "3",
                           "--output_dir", str(tmp_path / "step3"), *flags])
    _same_tree(tmp_path / "step3", tmp_path / "ours")


def test_convert_frames_to_video_matches_the_jax_script(tmp_path, monkeypatch):
    rng = np.random.default_rng(0)
    for clip, n in (("clip_a", 5), ("clip_b", 3)):
        (tmp_path / "frames" / clip).mkdir(parents=True)
        for i in range(n):
            frame = rng.integers(0, 256, (32, 48, 3), dtype=np.uint8)
            cv2.imwrite(str(tmp_path / "frames" / clip / f"{i:03d}.png"), frame)
    flags = ["--input_dir", str(tmp_path / "frames"), "--fps", "8"]
    _run_script(monkeypatch, "convert_frames_to_video",
                flags + ["--output_dir", str(tmp_path / "ref" / "videos"),
                         "--manifest", str(tmp_path / "ref.txt")])
    from dove_tpu_torch import convert_frames_to_video

    convert_frames_to_video.main(flags + ["--output_dir", str(tmp_path / "ours" / "videos"),
                                          "--manifest", str(tmp_path / "ours.txt")])
    assert (tmp_path / "ours.txt").read_text() == (tmp_path / "ref.txt").read_text() == (
        "videos/clip_a.mp4\nvideos/clip_b.mp4\n")
    for clip, n in (("clip_a", 5), ("clip_b", 3)):
        decoded = []
        for run in ("ours", "ref"):
            cap = cv2.VideoCapture(str(tmp_path / run / "videos" / f"{clip}.mp4"))
            frames = []
            while True:
                ok, frame = cap.read()
                if not ok:
                    break
                frames.append(frame)
            cap.release()
            decoded.append(np.stack(frames))
        assert decoded[0].shape == (n, 32, 48, 3)
        np.testing.assert_array_equal(decoded[0], decoded[1])
