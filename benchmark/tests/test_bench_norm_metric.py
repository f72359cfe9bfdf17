"""The reader of the VAE's fused-norm share on synthetic windows: the share
of norm sites that took the kernel, and nothing where the program (an older
one) counts no norm site."""

from __future__ import annotations

import pytest

from benchmark import harness


def read(units: list[dict]):
    mod = harness.load_module((harness.ROOT,), "metrics", "vae_norm_fused_pct.serve")
    return mod.read(harness.Window(cell=None, units=units, seconds=10.0, trace={}))


# a bf16 clip: 24 encode windows of 29 norm sites, 28 decode windows of 37
SITES = 24 * 29 + 28 * 37
OLD_CLIP = {"enc": 2.3, "dit": 1.1, "dec": 5.6, "wall": 9.1, "units": 32}


@pytest.mark.parametrize("fused,want", [(SITES, 100.0), (0, 0.0), (SITES // 2, 50.0)])
def test_vae_norm_fused_reads_the_share_of_sites(fused, want):
    units = [dict(OLD_CLIP, **{"vae.norm_n": SITES, "vae.norm_fused_n": fused})] * 2
    assert read(units) == pytest.approx(want, abs=0.1)


def test_vae_norm_fused_reads_nothing_without_the_counters():
    assert read([OLD_CLIP]) is None
    # the plain route counts its sites and no fused one
    assert read([dict(OLD_CLIP, **{"vae.norm_n": SITES})]) == 0.0
