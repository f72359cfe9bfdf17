"""The reader of the VAE's channels-last conv share on synthetic windows:
the share of float convs whose input was channels-last, and nothing where
the program (an older one) counts no conv."""

from __future__ import annotations

import pytest

from benchmark import harness


def read(units: list[dict]):
    mod = harness.load_module((harness.ROOT,), "metrics", "vae_conv_cl_pct.serve")
    return mod.read(harness.Window(cell=None, units=units, seconds=10.0, trace={}))


# a bf16 clip: 24 encode windows of 35 float convs, 28 decode windows of 117
CONVS = 24 * 35 + 28 * 117
OLD_CLIP = {"enc": 1.1, "dit": 1.1, "dec": 2.2, "wall": 4.5, "units": 32,
            "vae.norm_n": 24 * 29 + 28 * 37}


@pytest.mark.parametrize("cl,want", [(CONVS, 100.0), (0, 0.0), (CONVS // 4, 25.0)])
def test_vae_conv_cl_reads_the_share_of_convs(cl, want):
    units = [dict(OLD_CLIP, **{"vae.conv_n": CONVS, "vae.conv_cl_n": cl})] * 2
    assert read(units) == pytest.approx(want, abs=0.1)


def test_vae_conv_cl_reads_nothing_without_the_counters():
    assert read([OLD_CLIP]) is None
    # an NCDHW route counts its convs and no channels-last one
    assert read([dict(OLD_CLIP, **{"vae.conv_n": CONVS})]) == 0.0
