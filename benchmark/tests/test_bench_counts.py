"""The yardstick by hand: operations and bytes of one attention and one
convolution, the convolutions the counter walks against the VAE's own, the
trace reduction on a made-up trace, and the readers on made-up windows."""

from __future__ import annotations

import json

import pytest
import torch

from benchmark import counts, harness, peaks
from benchmark import trace as tm
from benchmark.tests.fixtures_bench import REPO


def test_attention_by_hand():
    # [1, 48, 19426, 64]: Q K^T and P V, 2 * 19426^2 * 64 each per head
    w = counts.attention(1, 48, 19426, 19426, 64, 2)
    assert w.ops == 2 * 2 * 48 * 19426 * 19426 * 64
    assert w.nbytes == 2 * 48 * 64 * 4 * 19426  # q, k, v in, o out, bf16
    assert peaks.least_seconds(w.ops, w.nbytes, "bfloat16") == pytest.approx(w.ops / 989e12)


def test_conv_by_hand():
    # the decoder's top conv: 128 -> 128, 3x3x3, 33 x 768 x 1280 out, bf16
    vox = 33 * 768 * 1280
    w = counts.conv(128, 128, 27, vox, vox, 2)
    assert w.ops == 2 * 128 * 128 * 27 * vox
    assert w.nbytes == 2 * (128 * vox + 128 * 128 * 27 + 128 * vox)


@pytest.mark.parametrize("preset", ["cogvideox1.5-5b", "tiny"])
def test_vae_conv_walk_matches_the_modules(preset):
    import dataclasses

    from dove_tpu_torch.models.vae import AutoencoderKLCogVideoX
    from dove_tpu_torch.train.trainer import PRESETS

    cfg = PRESETS[preset]()
    with torch.device("meta"):
        vae = AutoencoderKLCogVideoX(cfg.vae)
    c = dataclasses.asdict(cfg)["vae"]
    for part, mod in (("encoder", vae.encoder), ("decoder", vae.decoder)):
        convs = [m for m in mod.modules() if isinstance(m, (torch.nn.Conv2d, torch.nn.Conv3d))]
        walked = counts.vae_convs(c, 9, 64, 64, part, 2)
        assert len(walked) == len(convs)
        assert all(w.ops > 0 and w.nbytes > 0 for w in walked)


def test_the_dit_counts_on_the_clip():
    c = json.loads((REPO / "benchmark/configs/cogvideox1.5-5b.json").read_text())
    sh = counts.staged_shapes(c, 32, 180, 320)
    assert sh == dict(frames=33, height=768, width=1280, lat_frames=9, lat_h=96, lat_w=160)
    video, text = counts.dit_tokens(c["dit"], 9, 96, 160)
    assert video + text == 19426  # [1, 48, 19426, 64] on the card
    D = 3072
    assert counts.dit_linear_ops(c["dit"], 1, video, text) >= 42 * 2 * 19426 * D * D * 12


def _event(name, cat, ts, dur):
    return {"name": name, "cat": cat, "ts": ts, "dur": dur}


def test_trace_reduction():
    events = [
        _event(tm.WINDOW_RANGE, "user_annotation", 0, 100),
        _event("dove.enc", "user_annotation", 0, 40),
        _event("dove.dec", "user_annotation", 60, 40),
        _event("sm90_xmma_fprop_implicit_gemm_bf16", "kernel", 5, 20),
        _event("flash_fwd_sm90_kernel<__nv_bfloat16, 64>", "kernel", 20, 10),
        _event("Memcpy DtoH", "gpu_memcpy", 70, 10),
        _event("outside", "kernel", 150, 10),
    ]
    s = tm.summarize_events(events)
    assert s["window_s"] == pytest.approx(100e-6)
    assert s["busy_s"] == pytest.approx(35e-6)  # [5, 30] and [70, 80]
    assert s["kinds"]["conv"] == pytest.approx(20e-6)
    assert s["kinds"]["k1_flash_fwd"] == pytest.approx(10e-6)
    assert s["gaps"]["dove.enc"] == pytest.approx(15e-6)  # [0, 5] and [30, 40]
    assert s["gaps"]["dove.dec"] == pytest.approx(30e-6)  # [60, 70] and [80, 100]
    assert s["gaps"][tm.WINDOW_RANGE] == pytest.approx(20e-6)  # [40, 60]
    assert tm.kernel_seconds(s, ("flash_fwd",)) == pytest.approx(10e-6)
    b = tm.breakdown(s)
    assert b["device_ops"][0][0] == "conv" and b["idle_gaps"][0][0] == "dove.dec"


def test_rooflines_stay_under_the_peak_for_a_kernel_at_the_bound():
    c = json.loads((REPO / "benchmark/configs/cogvideox1.5-5b.json").read_text())
    mix = json.loads((REPO / "benchmark/traffic/clip32_staged.json").read_text())
    cell = harness.Cell("x", 1, torch.device("cpu"), c, mix, {})
    attn = harness.load_module((harness.ROOT,), "metrics", "attn_roofline.serve")
    least = attn.least_seconds(c, mix)
    s = {"kernels": {"flash_fwd_sm90_kernel<bf16>": [least, 42]}}
    ctx = harness.Window(cell, [{"units": 32}], 9.0, s)
    assert attn.read(ctx) == pytest.approx(100.0)
    conv = harness.load_module((harness.ROOT,), "metrics", "conv_roofline.serve")
    s = {"kernels": {"sm90_xmma_fprop_implicit_gemm": [2 * conv.least_seconds(c, mix), 9],
                     "cudnn::nchwToNhwcKernel": [1.0, 9]}}
    assert conv.read(harness.Window(cell, [{"units": 32}], 9.0, s)) == pytest.approx(50.0)
    assert attn.read(harness.Window(cell, [{}], 9.0, {"kernels": {}})) is None
