"""Parity of the PyTorch port's small ops with dove_tpu (fp32, CPU).

The schedule, rope and host geometry at atol 1e-6, plus the places where the
two frameworks could quietly differ: bilinear upscaling at the edges and
round-half-to-even in the uint8 quantizer.
"""

from __future__ import annotations

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dove_tpu import tiling as jtiling
from dove_tpu.config import SchedulerConfig as JSchedulerConfig
from dove_tpu.ops import rope as jrope
from dove_tpu.ops.scheduler import Schedule as JSchedule
from dove_tpu.pipeline import DovePipeline as JPipeline
from dove_tpu_torch import tiling as ttiling
from dove_tpu_torch.config import SchedulerConfig
from dove_tpu_torch.ops import rope as trope
from dove_tpu_torch.ops.scheduler import Schedule
from dove_tpu_torch.pipeline import DovePipeline, bilinear_upscale
from torch_threads import two_torch_threads  # noqa: F401 (autouse)

ATOL = 1e-6


@pytest.mark.parametrize("shift", [1.0, 3.0])
def test_schedule_table_and_algebra(shift):
    j = JSchedule.create(JSchedulerConfig(snr_shift_scale=shift))
    t = Schedule.create(SchedulerConfig(snr_shift_scale=shift))
    np.testing.assert_allclose(t.alphas_cumprod.numpy(), np.asarray(j.alphas_cumprod),
                               atol=ATOL, rtol=0)
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 4, 3, 5, 5)).astype(np.float32)
    eps = rng.standard_normal(x.shape).astype(np.float32)
    steps = np.array([399, 17], np.int32)
    for name in ("add_noise", "velocity_to_x0"):
        ref = getattr(j, name)(jnp.asarray(x), jnp.asarray(eps), jnp.asarray(steps))
        ours = getattr(t, name)(torch.from_numpy(x), torch.from_numpy(eps),
                                torch.from_numpy(steps))
        np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=ATOL, rtol=0)


@pytest.mark.parametrize("dims", [(64, 5, 45, 80), (16, 2, 4, 4), (64, 1, 3, 7)])
def test_rope_tables_and_rotation(dims):
    head_dim, f, h, w = dims
    jc, js = jrope.rope_3d(head_dim, f, h, w)
    tc, ts = trope.rope_3d(head_dim, f, h, w)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=ATOL, rtol=0)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), atol=ATOL, rtol=0)
    x = np.random.default_rng(1).standard_normal((1, 2, f * h * w, head_dim)).astype(
        np.float32)
    ref = jrope.apply_rotary(jnp.asarray(x), jc, js)
    ours = trope.apply_rotary(torch.from_numpy(x), tc, ts)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=ATOL, rtol=0)


def test_frame_geometry_matches():
    for n in range(1, 70):
        assert ttiling.next_valid_frames(n) == jtiling.next_valid_frames(n)
        for cl, ot in [(0, 8), (33, 8), (17, 4), (9, 0)]:
            assert ttiling.temporal_chunks(n, cl, ot) == jtiling.temporal_chunks(n, cl, ot)
    frames = np.random.default_rng(2).uniform(size=(6, 13, 21, 3)).astype(np.float32)
    (a, pa), (b, pb) = ttiling.pad_video(frames), jtiling.pad_video(frames)
    assert pa == pb and np.array_equal(a, b)
    clip = np.random.default_rng(3).integers(0, 255, (3, 24, 20), dtype=np.uint8)
    assert np.array_equal(ttiling.i420_crop(clip, 12, 18), jtiling.i420_crop(clip, 12, 18))
    vol = np.arange(3 * 9 * 8 * 8, dtype=np.float32).reshape(3, 9, 8, 8)
    assert np.array_equal(ttiling.unpad_video(vol, 1, 2, 3),
                          jtiling.unpad_video(vol, 1, 2, 3))
    for ts, te in [(0, 33), (25, 58), (50, 83)]:
        ours = ttiling.valid_region(ttiling.Tile(ts, te, 0, 1, 0, 1), (83, 1, 1), 8, (0, 0))
        ref = jtiling.valid_region(jtiling.Tile(ts, te, 0, 1, 0, 1), (83, 1, 1), 8, (0, 0))
        assert (ours.src, ours.dst) == (ref.src, ref.dst)


@pytest.mark.parametrize("shape", [(1, 2, 5, 7, 3), (1, 1, 1, 2, 3), (1, 3, 4, 1, 3)])
def test_bilinear_upscale_matches_jax_resize_at_edges(shape):
    """jax.image.resize(..., "bilinear") upsampling and F.interpolate with
    align_corners=False agree everywhere, the clamped border rows and columns
    included."""
    x = np.random.default_rng(4).uniform(-1, 1, shape).astype(np.float32)
    B, F, H, W, C = shape
    ref = jax.image.resize(jnp.asarray(x), (B, F, H * 4, W * 4, C), "bilinear")
    ours = bilinear_upscale(torch.from_numpy(x), 4)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=ATOL, rtol=0)
    ref = np.asarray(ref)
    np.testing.assert_allclose(ours.numpy()[:, :, 0], ref[:, :, 0], atol=ATOL)
    np.testing.assert_allclose(ours.numpy()[:, :, :, -1], ref[:, :, :, -1], atol=ATOL)


def test_round_half_to_even_in_quantize_frames():
    halves = np.array([0.5, 1.5, 2.5, 3.5, 126.5, 253.5, 254.5], np.float32)
    assert np.array_equal(np.asarray(jnp.round(jnp.asarray(halves))),
                          torch.round(torch.from_numpy(halves)).numpy())
    assert np.array_equal(torch.round(torch.from_numpy(halves)).numpy(),
                          [0, 2, 2, 4, 126, 254, 254])
    # values whose *255 products land on exact halves in fp32
    k = np.arange(0, 255, dtype=np.float32) + 0.5
    out01 = (k / 255.0).astype(np.float32)
    exact = (out01 * np.float32(255.0)) == k
    assert exact.sum() > 50
    vals = out01[exact]
    out01 = np.broadcast_to(vals[:, None], (vals.size, 3))[None, None, None].copy()
    jself = types.SimpleNamespace(output_i420=False)
    ref = np.asarray(JPipeline._quantize_frames(jself, jnp.asarray(out01)))
    tself = types.SimpleNamespace(output_i420=False)
    ours = DovePipeline.quantize_frames(tself, torch.from_numpy(out01)).numpy()
    assert np.array_equal(ours, ref)


def test_i420_quantize_within_one_lsb():
    out01 = np.random.default_rng(5).uniform(0, 1, (1, 2, 6, 8, 3)).astype(np.float32)
    ns = types.SimpleNamespace(output_i420=True)
    ref = np.asarray(JPipeline._quantize_frames(ns, jnp.asarray(out01)))
    ours = DovePipeline.quantize_frames(ns, torch.from_numpy(out01)).numpy()
    assert ours.shape == ref.shape == (1, 2, 9, 8)
    assert np.abs(ours.astype(int) - ref.astype(int)).max() <= 1
