"""The harness on the CPU: every file BENCHMARK.json names loads, a cell is
added by files alone, both drivers run on the tiny preset and the program
agrees with the plain reference there, the configuration files are the
port's presets and the reference names the program's tensors."""

from __future__ import annotations

import json
import re

import pytest
import torch

from benchmark import harness
from benchmark.reference import models as ref_models
from benchmark.tests.fixtures_bench import (  # noqa: F401
    REPO, run_tiny, tiny_bench, tiny_root, torch_threads)

BENCH = json.loads((REPO / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def test_benchmark_file_follows_the_contract():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["benchmark"] and 1 <= BENCH["run_seconds"] <= 51
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer")
             for x in BENCH[k]]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    assert e2e == {"frames_per_s", "train_samples_per_s", "peak_gib", "setup_s"}
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    pairs = {(w["config"], w["traffic"]) for w in BENCH["workloads"]}
    assert len(pairs) == len(BENCH["workloads"])
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e and m["source"] in (
            "device_trace", "program_span", "program_counter", "host_clock")
    assert len(json.dumps(BENCH)) < 64 * 1024


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_every_cell_loads(cell):
    c, spec = harness.make_cell((harness.ROOT,), cell, 1, "cpu")
    assert spec["name"] == cell and c.mix["kind"] in ("serve_clip", "train_s1")
    entry = next(w for w in BENCH["workloads"] if w["name"] == cell)
    assert (entry["config"], entry["traffic"]) == (spec["config"], spec["traffic"])
    assert entry["chips"] == spec["chips"] == 1 and entry["why"] == spec["why"]
    driver = harness.load_module((harness.ROOT,), "drivers", c.mix["kind"])
    assert hasattr(driver, "Job") and driver.RATE in {m["name"] for m in BENCH["end_to_end"]}
    rate = next(m for m in BENCH["end_to_end"] if m["name"] == driver.RATE)
    assert cell in rate["workloads"]


@pytest.mark.parametrize("metric", [m["name"] for m in BENCH["per_layer"]])
def test_every_metric_file_declares_what_the_benchmark_says(metric):
    entry = next(m for m in BENCH["per_layer"] if m["name"] == metric)
    mod = harness.load_module((harness.ROOT,), "metrics", metric)
    assert (mod.UNIT, mod.MOVES, mod.SOURCE) == (entry["unit"], entry["moves"], entry["source"])
    assert callable(mod.read)


@pytest.mark.parametrize("config", [c["name"] for c in BENCH["configs"]])
def test_config_files_are_the_ports_presets(config):
    import dataclasses

    from dove_tpu_torch.train.trainer import PRESETS

    entry = next(c for c in BENCH["configs"] if c["name"] == config)
    data = json.loads((REPO / entry["file"]).read_text())
    preset = dataclasses.asdict(PRESETS[data["preset"]]())
    preset["vae"]["block_out_channels"] = list(preset["vae"]["block_out_channels"])
    for key in ("dit", "vae", "scheduler", "sr_noise_step", "noise_step", "upscale"):
        assert data[key] == preset[key], key
    assert data["reduced"] == entry["reduced"] == [] and entry["source"] == data["source"]


@pytest.mark.parametrize("preset", ["cogvideox1.5-5b", "cogvideox-2b", "tiny"])
def test_reference_names_every_tensor_of_the_program(preset):
    import dataclasses

    from dove_tpu_torch.models.dit import CogVideoXTransformer3D
    from dove_tpu_torch.models.vae import AutoencoderKLCogVideoX
    from dove_tpu_torch.train.trainer import PRESETS

    cfg = PRESETS[preset]()
    with torch.device("meta"):
        dit, vae = CogVideoXTransformer3D(cfg.dit), AutoencoderKLCogVideoX(cfg.vae)
    c = dataclasses.asdict(cfg)
    for model, spec in ((dit, ref_models.dit_spec(c["dit"])), (vae, ref_models.vae_spec(c["vae"]))):
        assert sorted(spec) == sorted((k, tuple(v.shape)) for k, v in model.state_dict().items())


@pytest.mark.parametrize("cell", ["tiny_clip", "tiny2b_clip", "tiny_train"])
def test_a_cell_added_by_files_alone_runs_and_agrees_with_the_reference(run_tiny, cell):
    out = run_tiny(cell)
    assert out["correct"], out["checks"]
    assert list(out)[-1] == "checks" and out["attempted"] == 1 and out["failed"] == 0
    assert set(out["metrics"]) >= {"peak_gib", "setup_s"}
    assert out["device"]["platform"] == "cpu"


def test_a_traced_run_reads_the_span_metrics(run_tiny):
    out = run_tiny("tiny_clip", traced=True)
    got = set(out["metrics"])
    assert {"enc_s.serve", "dit_s.serve", "dec_s.serve", "glue_s.serve",
            "mfu_pct.serve", "device_idle_pct.serve"} <= got
    # no kernel of the card ran, so the rooflines have nothing to read
    assert not got & {"attn_roofline.serve", "conv_roofline.serve"}
    assert out["metrics"]["dit_s.serve"]["value"] > 0
    assert out["correct"], out["checks"]


def test_same_seed_same_inputs_and_weights():
    from benchmark import weights
    from benchmark.drivers.serve_clip import clip

    spec = [("a.weight", (3, 4)), ("a.bias", (3,)), ("b.weight", (5, 2, 3)), ("n.weight", (4,))]
    one = weights.make(spec, 2**31 + 5, weights.DIT, torch.float32, "cpu")
    two = weights.make(list(reversed(spec)), 2**31 + 5, weights.DIT, torch.float32, "cpu")
    assert all(torch.equal(one[k], two[k]) for k in one)
    assert float(one["a.bias"].abs().max()) == 0 and bool((one["n.weight"] == 1).all())
    assert (clip(7, 0, 8, 16, 16) == clip(7, 0, 8, 16, 16)).all()
    assert not (clip(7, 0, 8, 16, 16) == clip(7, 1, 8, 16, 16)).all()
