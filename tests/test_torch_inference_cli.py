"""``python -m dove_tpu_torch.inference`` against ``scripts/inference.py``.

Both CLIs' ``main`` run on the CPU in fp32 on one tiny_test() checkpoint
directory this test writes (diffusers layout: the JAX package's seeded
weights), so that each CLI's own ``load_pipeline`` reads the same weights,
config, ``--lora_path`` and flags. Each package's ``DovePipeline`` is
wrapped to take the posterior mean (the frameworks' RNGs cannot match).
The staged path (``--is_vae_st``), the fused path in spatial tiles and
temporal chunks, and the fused path at ``--upscale 1`` with a LoRA that the
port's exporter wrote: the ``--png_save`` frames agree within one LSB. With
``--gt_dir --eval_metrics psnr,ssim`` the port's JSON has the JAX CLI's
schema, holds what ``dove_tpu.eval.metrics`` computes on the port's own
frames within 1e-6, and the JAX CLI's values within what one-LSB frame
differences allow. ``--preset cogvideox-2b`` (at tiny widths) and ``--dtype
float16`` run through the CLI and write the frames the in-process pipeline
gives on the same flags (1e-6). The refusals name their ROADMAP items.
"""

from __future__ import annotations

import dataclasses
import importlib
import json
import logging
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
from dove_tpu.eval import metrics as jmetrics
from dove_tpu.models import dit as jdit
from dove_tpu.models import vae as jvae
from dove_tpu_torch import inference
from dove_tpu_torch import safetensors_io
from dove_tpu_torch import weights as tweights
from dove_tpu_torch.eval import metrics as tmetrics
from dove_tpu_torch.io import video as tvideo
from dove_tpu_torch.train import checkpointing as tckpt
from test_torch_dit import golden_config

REPO = Path(__file__).resolve().parents[1]
METRIC_REL_TOL = 1e-6
# the JAX CLI's metrics against the port CLI's, whose frames differ by one LSB
CLI_METRIC_TOL = 2e-5


def _jax_cli():
    sys.path.insert(0, str(REPO / "scripts"))
    try:
        return importlib.import_module("inference")
    finally:
        sys.path.remove(str(REPO / "scripts"))


@pytest.fixture(scope="module")
def checkpoint(tmp_path_factory):
    """A diffusers-layout tiny_test() checkpoint and a LoRA directory."""
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
    rng = np.random.default_rng(0)
    L, d, r = cfg.dit.num_layers, cfg.dit.hidden_dim, 4
    lora = {t: {"A": torch.from_numpy(0.2 * rng.standard_normal((L, d, r)).astype(np.float32)),
                "B": torch.from_numpy(0.2 * rng.standard_normal((L, r, d)).astype(np.float32))}
            for t in ("to_q", "to_k", "to_v", "to_out")}
    tckpt.export_lora_safetensors(lora, root / "lora" / "pytorch_lora_weights.safetensors")
    return root


def _write_clip(path: Path, frames: int, h: int, w: int, seed: int) -> None:
    path.parent.mkdir(parents=True, exist_ok=True)
    writer = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*"mp4v"), 8, (w, h))
    rng = np.random.default_rng(seed)
    for _ in range(frames):
        writer.write(rng.integers(0, 255, (h, w, 3), np.uint8))
    writer.release()


def _mean_posterior(monkeypatch):
    """Both packages' DovePipeline, as their load_pipeline builds it, with
    sample_posterior=False."""
    built = {}
    for name, mod in (("jax", jpipeline), ("torch", tpipeline)):
        cls = mod.DovePipeline

        def make(cls=cls, name=name, **kw):
            built[name] = cls(**{**kw, "sample_posterior": False})
            return built[name]

        monkeypatch.setattr(mod, "DovePipeline", make)
    return built


def _run_both(tmp_path, checkpoint, monkeypatch, clip, flags, port_flags=()):
    frames, h, w = clip
    _write_clip(tmp_path / "in" / "clip.mp4", frames, h, w, seed=1)
    built = _mean_posterior(monkeypatch)
    common = ["--input_dir", str(tmp_path / "in"), "--model_path", str(checkpoint),
              "--dtype", "float32", "--seed", "0", *flags]
    _jax_cli().main(common + ["--output_path", str(tmp_path / "jax")])
    inference.main(common + ["--output_path", str(tmp_path / "ours"), "--device", "cpu",
                             *port_flags])
    return built


CASES = {
    "staged": ((9, 16, 24), ["--is_vae_st", "--png_save", "--is_cpu_offload"]),
    "fused_tiles_and_chunks": ((17, 16, 16), [
        "--tile_size_hw", "32", "32", "--overlap_hw", "16", "16", "--chunk_len", "8",
        "--overlap_t", "4", "--tile_batch", "2", "--png_save"]),
    "fused_upscale_1_lora": ((9, 32, 32), ["--upscale", "1", "--png_save"]),
}


@pytest.mark.parametrize("case", list(CASES))
def test_png_frames_match_the_jax_cli(tmp_path, checkpoint, monkeypatch, case, caplog):
    clip, flags = CASES[case]
    if case.endswith("lora"):
        flags = flags + ["--lora_path", str(checkpoint / "lora")]
    if case == "staged":  # a prompt without a text encoder: warned, ignored
        (tmp_path / "prompts.json").write_text(json.dumps({"clip.mp4": "a cat"}))
        flags = flags + ["--input_json", str(tmp_path / "prompts.json")]
    with caplog.at_level(logging.WARNING):
        built = _run_both(tmp_path, checkpoint, monkeypatch, clip, flags)
    up = 1 if "--upscale" in flags else 4
    ref = tvideo.read_image_folder(tmp_path / "jax" / "clip")
    ours = tvideo.read_image_folder(tmp_path / "ours" / "clip")
    assert ours.shape == ref.shape == (clip[0], clip[1] * up, clip[2] * up, 3)
    assert np.abs(np.round((ours - ref) * 255)).max() <= 1
    tp, jp = built["torch"], built["jax"]
    assert tp.vae_tiling == jp.vae_tiling == (case == "staged")
    assert tp.output_uint8 == jp.output_uint8 and not tp.output_i420
    assert tp.config == tcfg_from(jp.config)
    if case == "staged":
        assert "prompt for clip.mp4 ignored" in caplog.text


def tcfg_from(cfg_j):
    """The JAX config's fields as the port's config (same dataclass layout)."""
    from dove_tpu_torch import config as tcfg

    return tcfg.PipelineConfig(
        dit=tcfg.DiTConfig(**dataclasses.asdict(cfg_j.dit)),
        vae=tcfg.VAEConfig(**dataclasses.asdict(cfg_j.vae)),
        scheduler=tcfg.SchedulerConfig(**dataclasses.asdict(cfg_j.scheduler)),
        **{f.name: getattr(cfg_j, f.name) for f in dataclasses.fields(cfg_j)
           if f.name not in ("dit", "vae", "scheduler")})


def test_lora_path_is_fused(checkpoint):
    """--lora_path (a directory) fuses the exported LoRA into the DiT that
    load_pipeline returns."""
    args = inference.build_parser().parse_args([
        "--input_dir", ".", "--model_path", str(checkpoint), "--dtype", "float32",
        "--device", "cpu"])
    plain = inference.load_pipeline(args)
    args.lora_path = str(checkpoint / "lora")
    fused = inference.load_pipeline(args)
    cfg = plain.config.dit
    want = tweights.fuse_lora_into_dit(
        tweights.convert_dit(safetensors_io.load_file(
            checkpoint / "transformer" / "diffusion_pytorch_model.safetensors"),
            cfg, torch.float32),
        safetensors_io.load_file(checkpoint / "lora" / "pytorch_lora_weights.safetensors"))
    for k, v in want.state_dict().items():
        assert torch.equal(fused.dit.state_dict()[k], v), k
    assert not torch.equal(fused.dit.state_dict()["transformer_blocks.0.attn1.to_q.weight"],
                           plain.dit.state_dict()["transformer_blocks.0.attn1.to_q.weight"])


def test_inline_metrics_match_the_jax_cli(tmp_path, checkpoint, monkeypatch):
    """--gt_dir --eval_metrics psnr,ssim on the staged path: the JSON's
    schema and sample names are the JAX CLI's; its values are what
    dove_tpu.eval.metrics gives on the port's own frames (1e-6), and the JAX
    CLI's within the spread that one-LSB output differences allow."""
    _write_clip(tmp_path / "gt" / "clip.mp4", 9, 64, 96, seed=2)
    scored = []
    add = tmetrics.MetricAccumulator.add
    monkeypatch.setattr(tmetrics.MetricAccumulator, "add",
                        lambda self, name, pred, gt: scored.append((pred, gt))
                        or add(self, name, pred, gt))
    _run_both(tmp_path, checkpoint, monkeypatch, (9, 16, 24),
              ["--is_vae_st", "--gt_dir", str(tmp_path / "gt"), "--eval_metrics",
               "psnr,ssim"])
    name = "metrics_psnr_ssim.json"
    ref = json.loads((tmp_path / "jax" / name).read_text())
    ours = json.loads((tmp_path / "ours" / name).read_text())
    assert ours.keys() == ref.keys() == {"per_sample", "average", "count"}
    assert ours["count"] == ref["count"] == 1
    (pred, gt), = scored
    assert pred.dtype == np.float32 and pred.shape == (9, 64, 96, 3)
    for metric in ("psnr", "ssim"):
        want = getattr(jmetrics, metric)(*jmetrics.match_resolution(pred, gt))
        got = ours["per_sample"][metric][0]
        assert abs(got - want) <= METRIC_REL_TOL * abs(want), (metric, got, want)
        assert ours["average"][metric] == got
    # the frames differ by one LSB at a share of the pixels (a 1e-6 float
    # difference crosses a rounding boundary), so the JAX CLI's numbers are
    # held just above what that gives: 2e-5, PSNR relative, SSIM absolute
    # (measured 1.9e-6 and 5.3e-6)
    psnr, ssim = (ref["average"][k] for k in ("psnr", "ssim"))
    assert abs(ours["average"]["psnr"] - psnr) <= CLI_METRIC_TOL * psnr
    assert abs(ours["average"]["ssim"] - ssim) <= CLI_METRIC_TOL


def test_every_flag_of_the_jax_cli_is_accepted():
    ours = {s for a in inference.build_parser()._actions for s in a.option_strings}
    ref = {s for a in _jax_cli().build_parser()._actions for s in a.option_strings}
    assert ref <= ours, sorted(ref - ours)
    assert ours - ref == {"--device", "--hand_conv"}


@pytest.mark.parametrize("flags,error,match", [
    (["--tensor_parallel", "2"], SystemExit, r"staged path; add --is_vae_st"),
    (["--tensor_parallel", "3", "--is_vae_st"], ValueError, r"tensor_parallel=3 must divide"),
])
def test_unported_flags_are_refused(tmp_path, flags, error, match):
    """What the JAX CLI refuses of the mesh flags (scripts/inference.py:
    273-277 and validate_tp), the port refuses too; the multi-rank runs are
    tests/test_torch_parallel.py's."""
    with pytest.raises(error, match=match):
        inference.main(["--input_dir", str(tmp_path), "--device", "cpu",
                        "--preset", "tiny", *flags])


@pytest.mark.parametrize("case", ["preset_cogvideox_2b", "dtype_float16"])
def test_2b_and_fp16_run_through_the_cli(tmp_path, checkpoint, monkeypatch, case):
    """What ROADMAP A.10 and A.14 refused until they were ported: the 2B
    preset (seeded weights, monkeypatched to tiny widths) and an fp16
    pipeline on the tiny checkpoint, staged, through ``main``; its PNG frames
    are the frames ``load_pipeline`` + ``process_video_file`` give in-process
    on the same flags (within 1e-6, i.e. the same uint8 values)."""
    from dove_tpu_torch import config as tcfg
    from dove_tpu_torch.io import video as video_io

    monkeypatch.setattr(tcfg, "cogvideox_2b", lambda: golden_config("2b"))
    _write_clip(tmp_path / "in" / "clip.mp4", 9, 16, 16, seed=4)
    flags = ["--input_dir", str(tmp_path / "in"), "--device", "cpu", "--seed", "0",
             "--is_vae_st", "--png_save"]
    flags += (["--preset", "cogvideox-2b", "--dtype", "float32"]
              if case.startswith("preset") else
              ["--model_path", str(checkpoint), "--dtype", "float16"])
    inference.main(flags + ["--output_path", str(tmp_path / "out")])
    args = inference.build_parser().parse_args(flags + ["--output_path", "."])
    pipe = inference.load_pipeline(args)
    assert pipe.dtype == (torch.float16 if case.startswith("dtype") else torch.float32)
    assert (pipe.config.dit.patch_size_t is None) == case.startswith("preset")
    want = pipe.process_video_file(tmp_path / "in" / "clip.mp4",
                                   **inference.process_kwargs(args))
    got = video_io.read_image_folder(tmp_path / "out" / "clip")
    assert want.dtype == np.uint8 and got.shape == want.shape == (9, 64, 64, 3)
    np.testing.assert_allclose(got, want.astype(np.float32) / 255.0, atol=1e-6, rtol=0)


def test_a_prompt_beside_a_t5_checkpoint_is_refused(tmp_path, checkpoint):
    _write_clip(tmp_path / "in" / "clip.mp4", 9, 16, 16, seed=3)
    (tmp_path / "model").mkdir()
    (tmp_path / "model" / "text_encoder").mkdir()
    (tmp_path / "p.json").write_text(json.dumps({"clip": "a cat"}))
    with pytest.raises(NotImplementedError, match=r"T5.*ROADMAP A\.13"):
        inference.main(["--input_dir", str(tmp_path / "in"), "--device", "cpu",
                        "--model_path", str(tmp_path / "model"),
                        "--input_json", str(tmp_path / "p.json")])
