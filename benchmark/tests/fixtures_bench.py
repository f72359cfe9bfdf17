"""Fixtures of the benchmark's CPU tests (imported by each test file): a tiny
cell of each driver, made as new files under a temporary root that the
harness searches before its own."""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]

SEED = 2**31 + 977  # past 32 signed bits, as the driver's seeds are


def tiny_config() -> dict:
    from dove_tpu_torch.config import tiny_test

    c = dataclasses.asdict(tiny_test())
    c["vae"]["block_out_channels"] = list(c["vae"]["block_out_channels"])
    return {"name": "tiny", "source": "the port's tiny_test preset", "preset": "tiny",
            "dtype": "float32", "reduced": [], "dit": c["dit"], "vae": c["vae"],
            "scheduler": c["scheduler"], "sr_noise_step": c["sr_noise_step"],
            "noise_step": c["noise_step"], "upscale": c["upscale"]}


@pytest.fixture(autouse=True)
def torch_threads():
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="session")
def tiny_root(tmp_path_factory) -> Path:
    """Two tiny configurations (the 1.5 and the 2B structure), two traffic
    mixes and three cells, as files alone: a clip of 8x16x80 (two encode and
    two decode windows) on each configuration and a stage-1 step of
    2x9x32x64, all in float32, with tight limits."""
    root = tmp_path_factory.mktemp("bench_root")
    for d in ("configs", "traffic", "workloads"):
        (root / d).mkdir()

    def put(folder, name, obj):
        (root / folder / f"{name}.json").write_text(json.dumps(obj))

    put("configs", "tiny", tiny_config())
    two = tiny_config()  # the 2B's structure: conv patches, sincos positions
    two["dit"].update(patch_size_t=None, patch_bias=True, sample_frames=49,
                      use_rotary_positional_embeddings=False, sample_height=60,
                      sample_width=90)
    put("configs", "tiny2b", dict(two, name="tiny2b"))
    put("traffic", "tiny_clip", {"kind": "serve_clip", "frames": 8, "height": 16,
                                 "width": 80, "path": "staged", "quantize": None})
    mix = json.loads((REPO / "benchmark" / "traffic" / "train_s1.json").read_text())
    mix.update(batch_size=2, resolution=[9, 32, 64], rank=4, lora_alpha=4)
    put("traffic", "tiny_train", mix)
    put("workloads", "tiny_clip", {"name": "tiny_clip", "config": "tiny",
                                   "traffic": "tiny_clip", "chips": 1, "why": "test",
                                   "limits": {"rms_lsb": 0.1, "worst_frame_rms_lsb": 0.2}})
    put("workloads", "tiny2b_clip", {"name": "tiny2b_clip", "config": "tiny2b",
                                     "traffic": "tiny_clip", "chips": 1, "why": "test",
                                     "limits": {"rms_lsb": 0.1, "worst_frame_rms_lsb": 0.2}})
    put("workloads", "tiny_train", {"name": "tiny_train", "config": "tiny",
                                    "traffic": "tiny_train", "chips": 1, "why": "test",
                                    "limits": {"loss_rel": 1e-5, "grad_rel": 1e-4,
                                               "change_rel": 1e-4}})
    return root


@pytest.fixture(scope="session")
def tiny_bench() -> dict:
    """BENCHMARK.json with the tiny cells beside the cells of their kind."""
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m:
            serve = m["name"].endswith(".serve") or m["name"] == "frames_per_s"
            m["workloads"] += ["tiny_clip", "tiny2b_clip"] if serve else ["tiny_train"]
    return bench


@pytest.fixture(scope="session")
def run_tiny(tiny_root, tiny_bench):
    """``run_tiny(cell, **kw)``: one CPU run of a tiny cell through the harness."""
    from benchmark import harness

    def run(cell: str, seed: int = SEED, **kw) -> dict:
        return harness.run(cell, seed, 0.0, kw.pop("traced", False), device="cpu",
                           roots=(tiny_root, harness.ROOT), bench=tiny_bench, **kw)

    return run
