"""The readers of the program's spans and counters on synthetic windows: each
reads what a clip or a step of the program carries, and None where the
program (an older one, or another mode) carries nothing of it."""

from __future__ import annotations

import pytest

from benchmark import harness
from benchmark.tests.fixtures_bench import torch_threads  # noqa: F401


def read(metric: str, units: list[dict]):
    mod = harness.load_module((harness.ROOT,), "metrics", metric)
    return mod.read(harness.Window(cell=None, units=units, seconds=10.0, trace={}))


# a bf16 clip's window plan (4 x 6 encode windows of 26 x 29 latents, 4 x 7
# decode windows of 26 x 25, on a 96 x 160 frame), and an int8-dit clip's
# (3 x 5 of 34 x 34 for both)
BF16 = {"enc.windows_n": 24, "enc.window_px": 24 * 26 * 29, "enc.frame_px": 96 * 160,
        "dec.windows_n": 28, "dec.window_px": 28 * 26 * 25, "dec.frame_px": 96 * 160}
INT8DIT = {"enc.windows_n": 15, "enc.window_px": 15 * 34 * 34, "enc.frame_px": 96 * 160,
           "dec.windows_n": 15, "dec.window_px": 15 * 34 * 34, "dec.frame_px": 96 * 160}
OLD_CLIP = {"enc": 2.3, "dit": 1.1, "dec": 5.6, "wall": 9.1, "units": 32}
OLD_STEP = {"encode": 0.97, "dit_fwd_bwd": 1.19, "optimizer": 0.01, "wall": 2.1, "units": 2}


@pytest.mark.parametrize("plan,want", [(BF16, 15.36), (INT8DIT, 11.42)])
def test_window_waste_reads_the_plans_overlap(plan, want):
    got = read("vae_window_waste_pct.serve", [dict(OLD_CLIP, **plan)] * 2)
    assert got == pytest.approx(want, abs=0.005)
    assert read("vae_window_waste_pct.serve", [OLD_CLIP]) is None


def test_prep_reads_the_host_spans_around_the_stages():
    units = [dict(OLD_CLIP, prep=0.05, finish=0.02), dict(OLD_CLIP, prep=0.03, finish=0.04)]
    assert read("prep_s.serve", units) == pytest.approx(0.07)
    assert read("prep_s.serve", [OLD_CLIP]) is None


def test_dit_quant_reads_the_quantizer_spans_of_the_int8_modes():
    units = [dict(OLD_CLIP, **{"dit.quantize": 0.3, "dit.dequantize": 0.2})] * 3
    assert read("dit_quant_s.serve", units) == pytest.approx(0.5)
    # weight-only int8 has no activation quantizer, only the dequantization
    assert read("dit_quant_s.serve", [dict(OLD_CLIP, **{"dit.dequantize": 0.1})]) == 0.1
    assert read("dit_quant_s.serve", [OLD_CLIP]) is None


@pytest.mark.parametrize("metric,key", [("backward_s.train", "backward"),
                                        ("optimizer_s.train", "optimizer")])
def test_training_readers_take_the_steps_mean(metric, key):
    units = [dict(OLD_STEP, backward=0.8, optimizer=0.01),
             dict(OLD_STEP, backward=0.6, optimizer=0.03)]
    assert read(metric, units) == pytest.approx(0.7 if key == "backward" else 0.02)
    assert read(metric, [{"units": 2, "wall": 2.0}]) is None
