"""The Wan2.1 cell as a tiny cell on the CPU: its driver agrees with its
reference, every planted fault and control comes out not correct, the Wan
counts hold what a hand count gives, and the Wan rooflines read a trace."""

from __future__ import annotations

import dataclasses
import json
import math

import pytest

from benchmark.tests.fixtures_bench import (  # noqa: F401
    REPO, SEED, tiny_bench, tiny_config, tiny_root, torch_threads)

WAN = "tiny_wan_clip"


def tiny_wan_config() -> dict:
    from dove_tpu_torch.config import tiny_wan

    c = json.loads(json.dumps(dataclasses.asdict(tiny_wan())))
    full = json.loads((REPO / "benchmark" / "configs" / "wan2.1-t2v-14b.json").read_text())
    return dict(full, name="tiny_wan", dtype="float32", dit=c["dit"], vae=c["vae"])


@pytest.fixture(scope="module")
def wan_root(tiny_root):
    """The tiny cell beside tiny_root's: Wan2.1 at dim 256 on a 5x16x24
    clip."""
    def put(folder, name, obj):
        (tiny_root / folder / f"{name}.json").write_text(json.dumps(obj))

    put("configs", "tiny_wan", tiny_wan_config())
    put("traffic", "tiny_wan_clip", {"kind": "serve_wan", "frames": 5, "height": 16,
                                     "width": 24, "path": "staged"})
    put("workloads", WAN, {"name": WAN, "config": "tiny_wan", "traffic": "tiny_wan_clip",
                           "chips": 1, "why": "test",
                           "limits": {"rms_lsb": 0.1, "worst_frame_rms_lsb": 0.2}})
    return tiny_root


@pytest.fixture(scope="module")
def run_cell(wan_root, tiny_bench):
    from benchmark import harness

    bench = json.loads(json.dumps(tiny_bench))
    for m in bench["end_to_end"] + bench["per_layer"]:
        if WAN in m.get("workloads", []) or "wan14b_bf16_clip32" in m.get("workloads", []):
            m["workloads"].append(WAN)

    def run(cell: str, seed: int = SEED, **kw) -> dict:
        return harness.run(cell, seed, 0.0, kw.pop("traced", False), device="cpu",
                           roots=(wan_root, harness.ROOT), bench=bench, **kw)

    return run


def test_the_wan_cell_agrees_with_its_reference(run_cell):
    out = run_cell(WAN)
    assert out["correct"], out["checks"]
    assert out["checks"]["rms_lsb"]["value"] < 0.05


def test_the_wan_cells_traced_run_reads_its_metrics(run_cell):
    out = run_cell(WAN, traced=True)
    m = out["metrics"]
    assert m["dit_attn_kernel_pct.serve"]["value"] == 0.0  # the CPU takes no kernel
    assert m["cross_attn_s.serve"]["value"] > 0
    assert m["wan_mfu_pct.serve"]["value"] > 0
    for name in ("enc_s.serve", "dit_s.serve", "dec_s.serve", "glue_s.serve", "prep_s.serve"):
        assert name in m
    assert "attn_d128_roofline.serve" not in m  # no K1 on the CPU
    assert "wan_conv_roofline.serve" not in m  # nor any device kernel
    assert out["correct"]


@pytest.mark.parametrize("fault", ["state_unchanged", "answer_altered"])
def test_a_planted_fault_in_the_wan_cell_is_not_correct(run_cell, fault):
    out = run_cell(WAN, fault=fault)
    assert not out["correct"], out["checks"]


@pytest.mark.parametrize("variant", ["fp8", "fp8-vae"])
def test_the_wan_cells_controls_are_not_correct(run_cell, variant):
    out = run_cell(WAN, variant=variant)
    assert not out["correct"], out["checks"]


def test_the_wan_cell_loads_as_the_harness_runs_it():
    """What test_bench_harness checks of every cell, for the serve_wan kind."""
    from benchmark import harness

    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    c, spec = harness.make_cell((harness.ROOT,), "wan14b_bf16_clip32", 1, "cpu")
    assert c.mix["kind"] == "serve_wan" and spec["chips"] == 1
    entry = next(w for w in bench["workloads"] if w["name"] == "wan14b_bf16_clip32")
    assert (entry["config"], entry["traffic"], entry["why"]) == (
        spec["config"], spec["traffic"], spec["why"])
    driver = harness.load_module((harness.ROOT,), "drivers", "serve_wan")
    assert hasattr(driver, "Job") and driver.RATE == "frames_per_s"
    rate = next(m for m in bench["end_to_end"] if m["name"] == driver.RATE)
    assert "wan14b_bf16_clip32" in rate["workloads"]


def test_the_wan_config_file_is_the_ports_preset():
    from benchmark.drivers import serve_wan
    from dove_tpu_torch.config import wan2_1_t2v_14b

    data = json.loads((REPO / "benchmark" / "configs" / "wan2.1-t2v-14b.json").read_text())
    preset = json.loads(json.dumps(dataclasses.asdict(wan2_1_t2v_14b())))
    for key in ("dit", "vae", "sr_noise_step", "noise_step", "upscale"):
        assert data[key] == preset[key], key
    assert data["scheduler"]["num_train_timesteps"] == preset["scheduler"]["num_train_timesteps"]
    assert serve_wan.pipeline_config(data) == wan2_1_t2v_14b()
    entry = next(c for c in json.loads((REPO / "BENCHMARK.json").read_text())["configs"]
                 if c["name"] == "wan2.1-t2v-14b")
    assert data["reduced"] == entry["reduced"] == [] and entry["source"] == data["source"]


def test_wan_counts_by_hand():
    from benchmark import counts_wan

    cfg = json.loads((REPO / "benchmark" / "configs" / "wan2.1-t2v-14b.json").read_text())
    mix = json.loads((REPO / "benchmark" / "traffic" / "clip32_wan.json").read_text())
    sh = counts_wan.clip_shapes(cfg, mix)
    assert (sh["frames"], sh["height"], sh["width"]) == (33, 768, 1280)
    assert (sh["lat_frames"], sh["lat_h"], sh["lat_w"], sh["tokens"]) == (9, 96, 160, 34560)
    d = counts_wan.dit_work(cfg, mix)
    S, D, L, F = 34560, 5120, 512, 13824
    assert d["self_attn"].ops == 40 * 4 * S * S * 128 * 40  # 2.446e13 a layer
    assert math.isclose(d["self_attn"].ops / 40, 2.446e13, rel_tol=1e-3)
    assert d["cross_attn"].ops == 40 * 4 * S * L * 128 * 40
    block = 2 * S * D * D * 6 + 2 * L * D * D * 2 + 2 * 2 * S * D * F
    edges = (2 * S * D * 64 + 2 * L * D * (4096 + D) + 2 * (256 * D + D * D + 6 * D * D)
             + 2 * S * D * 64)
    assert d["linear"].ops == 40 * block + edges
    total = sum(w.ops for w in counts_wan.clip_work(cfg, mix).values())
    assert 2.2e15 < total < 2.3e15  # 1.82e15 of DiT, ~4.2e14 of VAE
    vae = counts_wan.vae_work(cfg, mix)
    # the encoder's first conv: 3 -> 96, 27 taps, at every padded pixel
    assert vae[0].ops == 2 * 3 * 96 * 27 * 33 * 768 * 1280
    # the decoder's last: 96 -> 3 at every output pixel
    assert vae[-1].ops == 2 * 96 * 3 * 27 * 33 * 768 * 1280
    # the encoder's middle attention: one head of 384 over 96 x 160 positions, 9 frames
    hw = 96 * 160
    assert any(w.ops == 4 * 9 * hw * hw * 384 for w in vae)
    convs = counts_wan.vae_work(cfg, mix, attn=False)
    assert len(convs) == len(vae) - 2  # the encoder's and the decoder's middle attention
    assert sum(w.ops for w in vae) - sum(w.ops for w in convs) == 2 * 4 * 9 * hw * hw * 384


def test_the_wan_conv_roofline_reads_the_conv_kernels_alone():
    import torch

    from benchmark import harness

    cfg = json.loads((REPO / "benchmark" / "configs" / "wan2.1-t2v-14b.json").read_text())
    mix = json.loads((REPO / "benchmark" / "traffic" / "clip32_wan.json").read_text())
    conv = harness.load_module((harness.ROOT,), "metrics", "wan_conv_roofline.serve")
    least = conv.least_seconds(cfg, mix)
    assert 0.44 < least < 0.46  # 4.5e14 ops of convolutions at 989 TFLOP/s, a few bound by bytes
    cell = harness.Cell("x", 1, torch.device("cpu"), cfg, mix, {})
    s = {"kernels": {"sm90_xmma_fprop_implicit_gemm_bf16": [1.5 * least, 9],
                     "cudnn_infer_conv3d_kernel": [0.5 * least, 3],
                     "cudnn::nchwToNhwcKernel": [1.0, 9],
                     "fmha_cutlassF_bf16_aligned": [1.0, 2],
                     "flash_fwd_sm90_kernel_d128<__nv_bfloat16>": [1.0, 80]}}
    assert conv.read(harness.Window(cell, [{}], 9.0, s)) == pytest.approx(50.0)
    assert conv.read(harness.Window(cell, [{}], 9.0, {"kernels": {}})) is None
    other = harness.Cell("y", 1, torch.device("cpu"), tiny_config(), mix, {})
    assert conv.read(harness.Window(other, [{}], 9.0, s)) is None


def test_the_new_files_leave_the_cogvideox_counts_alone():
    from benchmark import counts_wan

    assert not counts_wan.is_wan(tiny_config())
