"""The port's still-image I/O (PIL) against dove_tpu's (cv2), bit for bit.

Seeded PNG frames (RGB, gray, RGBA, palette) written to a folder: the port's
``read_image_folder`` and ``load_sequence`` give dove_tpu's frames exactly,
also with ``cv2`` blocked in ``sys.modules`` (the GPU machine has no OpenCV);
frames the port's ``save_frames_as_png`` writes read back through dove_tpu
unchanged, and the other way round.
"""

from __future__ import annotations

import sys

import numpy as np
import pytest
from PIL import Image

from dove_tpu.io import video as jvideo
from dove_tpu_torch.io import video as tvideo


def _frames(seed: int, n: int = 3, h: int = 13, w: int = 17) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, 256, (n, h, w, 3), dtype=np.uint8)


@pytest.fixture
def png_folder(tmp_path):
    """Frames 0-3 in four PNG modes, named so that numeric order differs
    from lexicographic (0009 < 10)."""
    rng = np.random.default_rng(1)
    rgb = _frames(2, n=2)
    folder = tmp_path / "frames"
    folder.mkdir()
    Image.fromarray(rgb[0]).save(folder / "9.png")
    Image.fromarray(rng.integers(0, 256, (13, 17), dtype=np.uint8), "L").save(
        folder / "10.png")
    Image.fromarray(rng.integers(0, 256, (13, 17, 4), dtype=np.uint8), "RGBA").save(
        folder / "11.png")
    Image.fromarray(rgb[1]).convert("P", palette=Image.Palette.ADAPTIVE).save(
        folder / "12.png")
    return folder


def _block_cv2(monkeypatch):
    monkeypatch.setitem(sys.modules, "cv2", None)  # import cv2 -> ImportError
    with pytest.raises(ImportError):
        import cv2  # noqa: F401


def test_image_folder_equals_cv2_bit_for_bit(png_folder, monkeypatch):
    ref = jvideo.read_image_folder(png_folder)
    assert ref.shape == (4, 13, 17, 3)
    np.testing.assert_array_equal(tvideo.read_image_folder(png_folder), ref)
    np.testing.assert_array_equal(tvideo.load_sequence(png_folder), ref)
    single = png_folder / "11.png"
    np.testing.assert_array_equal(tvideo.load_sequence(single),
                                  jvideo.load_sequence(single))
    _block_cv2(monkeypatch)
    np.testing.assert_array_equal(tvideo.read_image_folder(png_folder), ref)
    np.testing.assert_array_equal(tvideo.load_sequence(single), ref[2:3])


def test_png_frames_round_trip_between_packages(tmp_path, monkeypatch):
    frames = _frames(3)
    jvideo.save_frames_as_png(frames, tmp_path / "j")
    _block_cv2(monkeypatch)
    tvideo.save_frames_as_png(frames.astype(np.float32) / 255.0, tmp_path / "t")
    assert sorted(p.name for p in (tmp_path / "t").iterdir()) == [
        "000.png", "001.png", "002.png"]
    np.testing.assert_array_equal(
        np.round(tvideo.read_image_folder(tmp_path / "j") * 255).astype(np.uint8), frames)
    monkeypatch.delitem(sys.modules, "cv2")
    np.testing.assert_array_equal(
        np.round(jvideo.read_image_folder(tmp_path / "t") * 255).astype(np.uint8), frames)


def test_unreadable_image_names_the_file(tmp_path, monkeypatch):
    _block_cv2(monkeypatch)
    bad = tmp_path / "broken.png"
    bad.write_bytes(b"not a png")
    with pytest.raises(ValueError, match="broken.png"):
        tvideo.load_sequence(bad)
    empty = tmp_path / "empty"
    empty.mkdir()
    with pytest.raises(ValueError, match="no images"):
        tvideo.read_image_folder(empty)
