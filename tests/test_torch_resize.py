"""ops/resize.py against cv2.resize on float32 (CPU).

Integer upscales (the fused path's --upscale_mode) and arbitrary up- and
downscales (CLIP-IQA's 224x224 cubic resize, MUSIQ's aspect-ratio-preserving
linear resizes) of seeded frames, in every mode, held at the bars below:
``linear``, ``nearest`` and ``area`` exact or within 1e-6, ``cubic`` within
3e-6 and ``lanczos4`` within 1e-6 (the largest differences measured are
1.8e-7, 0, 6e-8, 1.4e-6 and 4.8e-7: float32 rounding and FMA, not position).
Also: the cubic mode's border rule is F.interpolate's bicubic one, the
nearest mode is torch's "nearest" and not "nearest-exact", area on an
integer upscale is replication, and the op runs with cv2 absent.
"""

from __future__ import annotations

import sys

import cv2
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from dove_tpu_torch.ops import resize as tresize
from torch_threads import two_torch_threads  # noqa: F401 (autouse)

FLAGS = {"linear": cv2.INTER_LINEAR, "cubic": cv2.INTER_CUBIC,
         "nearest": cv2.INTER_NEAREST, "area": cv2.INTER_AREA,
         "lanczos4": cv2.INTER_LANCZOS4}
ATOL = {"linear": 1e-6, "nearest": 0.0, "area": 1e-6, "cubic": 3e-6, "lanczos4": 1e-6}

# (H, W) -> sizes out: integer upscales, CLIP's 224, MUSIQ's ARP sizes of a
# 720p frame, odd downscales, mixed up/down
CASES = [
    ((12, 20), [(48, 80), (36, 40), (224, 224), (6, 10), (8, 8), (24, 6), (31, 17)]),
    ((37, 45), [(111, 90), (224, 224), (18, 22), (24, 19)]),
    ((90, 160), [(360, 640), (224, 224), (126, 224), (63, 112)]),
    ((7, 5), [(224, 224), (28, 20)]),
]


def _cv2(frames: np.ndarray, size, mode: str) -> np.ndarray:
    return np.stack([cv2.resize(f, (size[1], size[0]), interpolation=FLAGS[mode])
                     for f in frames])


@pytest.mark.parametrize("mode", list(FLAGS))
def test_resize_matches_cv2(mode):
    rng = np.random.default_rng(0)
    for (H, W), outs in CASES:
        frames = rng.uniform(0, 1, (2, H, W, 3)).astype(np.float32)
        for size in outs:
            ref = _cv2(frames, size, mode)
            ours = tresize.resize(torch.from_numpy(frames), size, mode).numpy()
            assert ours.shape == ref.shape and ours.dtype == np.float32
            np.testing.assert_allclose(ours, ref, rtol=0, atol=ATOL[mode],
                                       err_msg=f"{(H, W)} -> {size}")


@pytest.mark.parametrize("scale", [2, 3, 4])
def test_integer_upscale_is_exact_where_the_arithmetic_allows(scale):
    """nearest and area replicate (bit for bit), linear within 1e-6."""
    frames = np.random.default_rng(1).uniform(0, 1, (3, 9, 14, 3)).astype(np.float32)
    size = (9 * scale, 14 * scale)
    x = torch.from_numpy(frames)
    for mode in ("nearest", "area"):
        ours = tresize.resize(x, size, mode).numpy()
        np.testing.assert_array_equal(ours, _cv2(frames, size, mode))
        np.testing.assert_array_equal(ours, frames.repeat(scale, 1).repeat(scale, 2))
    np.testing.assert_allclose(tresize.resize(x, size, "linear").numpy(),
                               _cv2(frames, size, "linear"), rtol=0, atol=1e-6)


def test_cubic_border_and_nearest_rule_are_torchs():
    """cubic: a = -0.75, half-pixel source, unclamped, replicated taps -- the
    border rule of F.interpolate(bicubic, align_corners=False); nearest is
    torch's "nearest" (floor(dst * scale)), not "nearest-exact"."""
    frames = np.random.default_rng(2).uniform(0, 1, (2, 11, 13, 3)).astype(np.float32)
    x = torch.from_numpy(frames)
    nchw = x.permute(0, 3, 1, 2)
    for size in ((44, 52), (5, 7), (224, 224)):
        bicubic = F.interpolate(nchw, size=size, mode="bicubic",
                                align_corners=False).permute(0, 2, 3, 1)
        torch.testing.assert_close(tresize.resize(x, size, "cubic"), bicubic,
                                   rtol=0, atol=3e-6)
        nearest = F.interpolate(nchw, size=size, mode="nearest").permute(0, 2, 3, 1)
        assert torch.equal(tresize.resize(x, size, "nearest"), nearest)
    exact = F.interpolate(nchw, size=(5, 7), mode="nearest-exact").permute(0, 2, 3, 1)
    assert not torch.equal(tresize.resize(x, (5, 7), "nearest"), exact)


def test_area_downscale_takes_fractional_boxes():
    """A non-integer area downscale weighs partial source cells (OpenCV's
    table), which adaptive_avg_pool2d's whole-cell windows do not."""
    frames = np.random.default_rng(3).uniform(0, 1, (1, 10, 10, 3)).astype(np.float32)
    ours = tresize.resize(torch.from_numpy(frames), (4, 4), "area")
    np.testing.assert_allclose(ours.numpy(), _cv2(frames, (4, 4), "area"), atol=1e-6)
    pooled = F.adaptive_avg_pool2d(torch.from_numpy(frames).permute(0, 3, 1, 2), 4)
    assert (ours - pooled.permute(0, 2, 3, 1)).abs().max() > 1e-3
    rows, w = tresize.axis_taps(10, 4, "area", True)
    np.testing.assert_allclose(w.sum(1), 1.0, atol=1e-6)
    assert rows.shape[1] == 3 and w[0, 2] == np.float32(0.2)  # a half pixel


def test_lanczos4_weights_sum_to_one_and_replicate_borders():
    idx, w = tresize.axis_taps(6, 24, "lanczos4")
    assert idx.shape == w.shape == (24, 8)
    np.testing.assert_allclose(w.sum(1), 1.0, atol=1e-6)
    assert idx.min() == 0 and idx.max() == 5


def test_resize_runs_without_cv2_and_rejects_bad_input(monkeypatch):
    frames = torch.rand(1, 6, 8, 3, generator=torch.Generator().manual_seed(4))
    monkeypatch.setitem(sys.modules, "cv2", None)
    for mode in tresize.MODES:
        assert tresize.resize(frames, (12, 16), mode).shape == (1, 12, 16, 3)
    assert tresize.resize(frames, (6, 8), "cubic") is frames
    with pytest.raises(ValueError, match="unknown resize mode"):
        tresize.resize(frames, (12, 16), "bilinear")
    with pytest.raises(ValueError, match=r"float \[N, H, W, C\]"):
        tresize.resize(frames[0], (12, 16))
