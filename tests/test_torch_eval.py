"""The port's evaluation harness against dove_tpu's (CPU).

PSNR, PSNR on Y and SSIM within 1e-6 (relative) of ``dove_tpu.eval.metrics``
on the same seeded clips; ``MetricAccumulator`` summaries with psnr, ssim,
lpips and dists, the learned metrics read from one state dict this test
writes, which both packages load (LPIPS and DISTS within the 1e-5 of
tests/test_torch_perceptual.py, fp32 through thirteen convs, of max(|ref|,
1): DISTS is 1 - a similarity near 1 for close frames); the color fixes
within 1e-5; the metric router's errors; and ``python -m
dove_tpu_torch.eval_metrics`` against ``scripts/eval_metrics.py`` on the same
PNG folders, JSON within 1e-6 (PSNR, SSIM) and 1e-5 (LPIPS, DISTS).
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest

from dove_tpu.eval import color_fix as jcolor
from dove_tpu.eval import metrics as jmetrics
from dove_tpu.eval import vgg as jvgg
from dove_tpu_torch import eval_metrics
from dove_tpu_torch import safetensors_io
from dove_tpu_torch.eval import color_fix as tcolor
from dove_tpu_torch.eval import metrics as tmetrics
from dove_tpu_torch.io import video as tvideo
from torch_threads import two_torch_threads  # noqa: F401 (autouse)

REPO = Path(__file__).resolve().parents[1]
REL_TOL = 1e-6  # float64 metrics
PERCEPTUAL_REL_TOL = 1e-5  # fp32 VGG16, tests/test_torch_perceptual.py
COLOR_ATOL = 1e-5
TOL = {"psnr": REL_TOL, "ssim": REL_TOL, "lpips": PERCEPTUAL_REL_TOL,
       "dists": PERCEPTUAL_REL_TOL}


def _clip_pair(seed: int, shape=(3, 37, 45, 3), noise: float = 0.05):
    rng = np.random.default_rng(seed)
    gt = rng.uniform(0, 1, shape).astype(np.float32)
    pred = np.clip(gt + rng.normal(0, noise, shape), 0, 1).astype(np.float32)
    return pred, gt


def _rel(a: float, b: float) -> float:
    return abs(a - b) / max(abs(b), 1e-30)


def _err(name: str, ours: float, ref: float) -> float:
    """The error the metric's bar applies to: relative, except that LPIPS
    and DISTS are sums of fp32 terms of order 1 (DISTS = 1 - a similarity
    near 1 for close frames), so their error is relative to max(|ref|, 1)."""
    if name in ("lpips", "dists"):
        return abs(ours - ref) / max(abs(ref), 1.0)
    return _rel(ours, ref)


@pytest.mark.parametrize("seed,shape,noise", [
    (0, (3, 37, 45, 3), 0.05),
    (1, (2, 11, 11, 3), 0.3),   # one SSIM window
    (2, (4, 64, 24, 3), 0.01),
    (3, (2, 20, 30, 3), 0.0),   # identical: PSNR 100 dB
])
def test_psnr_and_ssim_match_jax(seed, shape, noise):
    pred, gt = _clip_pair(seed, shape, noise)
    for name, ours in (("psnr", tmetrics.psnr(pred, gt)),
                       ("psnr_y", tmetrics.psnr_y(pred, gt)),
                       ("ssim", tmetrics.ssim(pred, gt, device="cpu"))):
        ref = getattr(jmetrics, name)(pred, gt)
        assert _rel(ours, ref) <= REL_TOL, (name, ours, ref)


def test_match_resolution_matches_jax():
    a = np.random.default_rng(4).random((5, 40, 50, 3)).astype(np.float32)
    b = np.random.default_rng(5).random((4, 44, 46, 3)).astype(np.float32)
    for mode in ("top-left", "center"):
        for ours, ref in zip(tmetrics.match_resolution(a, b, mode),
                             jmetrics.match_resolution(a, b, mode)):
            np.testing.assert_array_equal(ours, ref)


def _vgg_state_dicts(tmp_path: Path) -> dict[str, str]:
    """One LPIPS and one DISTS state dict (JAX's seeded VGG16, small seeded
    biases, seeded heads) in the exported layouts, as env var -> path."""
    params = jax.tree.map(np.asarray, jvgg.init_vgg16(jax.random.PRNGKey(0)))
    rng = np.random.default_rng(0)
    idx = (0, 2, 5, 7, 10, 12, 14, 17, 19, 21, 24, 26, 28)
    sd = {}
    for i, conv in zip(idx, (c for stage in params for c in stage)):
        sd[f"features.{i}.weight"] = np.ascontiguousarray(
            np.transpose(conv["kernel"], (3, 2, 0, 1)))
        sd[f"features.{i}.bias"] = (0.05 * rng.standard_normal(
            conv["bias"].shape)).astype(np.float32)
    chans = [3] + [c for c, _ in jvgg.VGG16_STAGES]
    dists = dict(sd, alpha=rng.uniform(0, 1, (1, sum(chans), 1, 1)).astype(np.float32),
                 beta=rng.uniform(0, 1, (1, sum(chans), 1, 1)).astype(np.float32))
    lpips = dict(sd)
    for k, (c, _) in enumerate(jvgg.VGG16_STAGES):
        lpips[f"lin{k}.model.1.weight"] = rng.uniform(0, 1, (1, c, 1, 1)).astype(np.float32)
    out = {}
    for name, tensors, env in (("dists", dists, "DOVE_DISTS_WEIGHTS"),
                               ("lpips", lpips, "DOVE_LPIPS_WEIGHTS")):
        path = tmp_path / f"{name}.safetensors"
        safetensors_io.save_file(tensors, path)
        out[env] = str(path)
    return out


@pytest.fixture(scope="module")
def metric_weights(tmp_path_factory):
    return _vgg_state_dicts(tmp_path_factory.mktemp("vgg"))


def test_accumulator_summaries_match_jax(metric_weights, monkeypatch):
    """Two samples (the second at another size, cropped to the common one)
    through both accumulators: per-sample values, averages and counts."""
    for env, path in metric_weights.items():
        monkeypatch.setenv(env, path)
    names = ["PSNR", "ssim", "lpips", "dists"]
    ref_acc = jmetrics.MetricAccumulator(names)
    ours_acc = tmetrics.MetricAccumulator(names, device="cpu")
    samples = [("a", *_clip_pair(6, (2, 32, 40, 3))),
               ("b", _clip_pair(7, (3, 36, 44, 3))[0], _clip_pair(8, (2, 32, 48, 3))[1])]
    for name, pred, gt in samples:
        ours = ours_acc.add(name, pred, gt)
        ref = ref_acc.add(name, pred, gt)
        assert ours.keys() == ref.keys()
        for k in ref:
            assert _err(k, ours[k], ref[k]) <= TOL[k], (name, k, ours[k], ref[k])
    ours_sum, ref_sum = ours_acc.summary(), ref_acc.summary()
    assert ours_sum["count"] == ref_sum["count"] == 2
    assert ours_acc.sample_names == ref_acc.sample_names == ["a", "b"]
    for k in ref_sum["average"]:
        assert _err(k, ours_sum["average"][k], ref_sum["average"][k]) <= TOL[k]
        for a, b in zip(ours_sum["per_sample"][k], ref_sum["per_sample"][k],
                        strict=True):
            assert _err(k, a, b) <= TOL[k]


NO_REFERENCE_ENV = {"clipiqa": "DOVE_CLIP_WEIGHTS", "niqe": "DOVE_NIQE_PARAMS",
                    "maniqa": "DOVE_MANIQA_WEIGHTS", "musiq": "DOVE_MUSIQ_WEIGHTS",
                    "ewarp": "DOVE_RAFT_WEIGHTS"}


def test_metric_router_errors(monkeypatch):
    """Without its weights each no-reference metric raises the JAX package's
    message (the port's own converter named where JAX names its), naming its
    environment variable; unknown names and missing --gt_dir raise."""
    for name, env in NO_REFERENCE_ENV.items():
        monkeypatch.delenv(env, raising=False)
        with pytest.raises(NotImplementedError, match=env) as ours:
            tmetrics.get_metric(name, device="cpu")
        with pytest.raises(NotImplementedError) as ref:
            jmetrics.get_metric(name)
        assert str(ours.value).replace("dove_tpu_torch/", "dove_tpu/") == str(ref.value)
    for mod in (tmetrics, jmetrics):
        with pytest.raises(ValueError, match="unknown metric 'psnrr'"):
            mod.get_metric("psnrr")
    monkeypatch.delenv("DOVE_LPIPS_WEIGHTS", raising=False)
    with pytest.raises(NotImplementedError, match="DOVE_LPIPS_WEIGHTS"):
        tmetrics.get_metric("lpips", device="cpu")
    acc = tmetrics.MetricAccumulator(["psnr", "ssim"], device="cpu")
    with pytest.raises(ValueError, match="needs --gt_dir"):
        acc.add("x", *_clip_pair(9)[:1], None)
    assert acc.summary()["count"] == 0 and acc.per_sample == {"psnr": [], "ssim": []}


@pytest.mark.parametrize("shape", [(2, 24, 40, 3), (33, 17, 3), (1, 5, 7, 3)])
def test_color_fix_matches_jax(shape):
    rng = np.random.default_rng(10)
    target = rng.random(shape, np.float32) * 0.5 + 0.25
    source = np.clip(target * 0.8 + 0.15 + rng.normal(0, 0.02, shape), 0, 1).astype(
        np.float32)
    for fn in ("adain_color_fix", "wavelet_color_fix"):
        np.testing.assert_allclose(getattr(tcolor, fn)(target, source),
                                   getattr(jcolor, fn)(target, source),
                                   atol=COLOR_ATOL, rtol=0)
    for ours, ref in zip(tcolor.wavelet_decomposition(target),
                         jcolor.wavelet_decomposition(target)):
        assert ours.dtype == ref.dtype
        np.testing.assert_allclose(ours, ref, atol=COLOR_ATOL, rtol=0)


def test_color_fix_needs_no_opencv(monkeypatch):
    monkeypatch.setitem(sys.modules, "cv2", None)
    target, source = _clip_pair(11, (1, 16, 16, 3))
    assert tcolor.wavelet_color_fix(target, source).shape == target.shape


def _folders(root: Path) -> tuple[Path, Path]:
    """pred/ and gt/ PNG folders: two matched samples of other sizes than
    their GT, one prediction without GT."""
    pred_dir, gt_dir = root / "pred", root / "gt"
    for i, (p_shape, g_shape) in enumerate([((3, 36, 44, 3), (3, 40, 48, 3)),
                                            ((2, 32, 32, 3), (3, 32, 36, 3))]):
        pred, _ = _clip_pair(20 + i, p_shape)
        _, gt = _clip_pair(30 + i, g_shape)
        tvideo.save_frames_as_png(pred, pred_dir / f"s{i}")
        tvideo.save_frames_as_png(gt, gt_dir / f"s{i}")
    tvideo.save_frames_as_png(_clip_pair(40, (1, 16, 16, 3))[0], pred_dir / "orphan")
    return pred_dir, gt_dir


@pytest.mark.parametrize("flags", [
    ["--metrics", "psnr,ssim,lpips,dists"],
    ["--metrics", "psnr,ssim", "--match_mode", "center", "--crop_border", "2",
     "--test_y_channel"],
], ids=["learned", "center_y"])
def test_eval_metrics_cli_matches_the_script(metric_weights, tmp_path, flags, monkeypatch):
    pred_dir, gt_dir = _folders(tmp_path)
    common = ["--pred_dir", str(pred_dir), "--gt_dir", str(gt_dir)] + flags
    env = {**os.environ, **metric_weights}
    res = subprocess.run(
        [sys.executable, str(REPO / "scripts" / "eval_metrics.py"), *common,
         "--output", str(tmp_path / "ref.json")],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-3000:]
    for k, v in metric_weights.items():
        monkeypatch.setenv(k, v)
    eval_metrics.main(common + ["--output", str(tmp_path / "ours.json"),
                                "--device", "cpu"])
    ref = json.loads((tmp_path / "ref.json").read_text())
    ours = json.loads((tmp_path / "ours.json").read_text())
    assert ours.keys() == ref.keys() == {"per_sample", "average", "count",
                                         "per_sample_names"}
    assert ours["count"] == ref["count"] == 2
    assert ours["per_sample_names"] == ref["per_sample_names"] == ["s0", "s1"]
    for k, v in ref["average"].items():
        assert _err(k, ours["average"][k], v) <= TOL[k], (k, ours["average"][k], v)
        for a, b in zip(ours["per_sample"][k], ref["per_sample"][k], strict=True):
            assert _err(k, a, b) <= TOL[k]
