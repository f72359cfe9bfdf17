"""Host-side media I/O (decode/encode) for the VSR pipeline.

A copy of ``dove_tpu/io/video.py``. Still images (an image folder, a single
image, PNG frame dumps) are read and written through PIL, which the GPU
machine has; video files through OpenCV, imported inside the functions that
use it, so a machine without OpenCV can import the port and run everything
but video-file I/O. Lossless output falls back to PNG sequences when no
lossless video codec is available through OpenCV.
"""

from __future__ import annotations

import contextlib
import logging
import os
import sys
from pathlib import Path

import numpy as np
import torch

logger = logging.getLogger(__name__)

VIDEO_EXTS = (".mp4", ".avi", ".mov", ".mkv")
IMAGE_EXTS = (".png", ".jpg", ".jpeg")

# resolved (once per process) by the first successful save_video codec probe
_MP4_FOURCC: str | None = None


@contextlib.contextmanager
def _quiet_stderr():
    """Silence C-level writes to fd 2 for the duration of the block.

    OpenCV's ffmpeg backend logs codec-probe failures directly to the stderr
    file descriptor (bypassing sys.stderr), so a Python-level redirect does
    nothing; dup fd 2 onto /dev/null and restore it afterwards.
    """
    sys.stderr.flush()
    try:
        saved_fd = os.dup(2)
    except OSError:  # pragma: no cover - fd 2 closed (daemonized)
        yield
        return
    devnull = os.open(os.devnull, os.O_WRONLY)
    try:
        os.dup2(devnull, 2)
        yield
    finally:
        os.dup2(saved_fd, 2)
        os.close(saved_fd)
        os.close(devnull)


def is_video_file(path: str | Path) -> bool:
    return str(path).lower().endswith(VIDEO_EXTS)


def read_video_frames(path: str | Path) -> np.ndarray:
    """Decode all frames -> [F, H, W, 3] float32 RGB in [0, 1]."""
    import cv2

    cap = cv2.VideoCapture(str(path))
    frames = []
    while True:
        ok, frame = cap.read()
        if not ok:
            break
        frames.append(cv2.cvtColor(frame, cv2.COLOR_BGR2RGB))
    cap.release()
    if not frames:
        raise ValueError(f"no frames decoded from {path}")
    return np.stack(frames).astype(np.float32) / 255.0


def _read_image(path: Path) -> np.ndarray:
    """One image -> [H, W, 3] uint8 RGB, as cv2.imread(IMREAD_COLOR) reads
    it: EXIF orientation applied, gray replicated, alpha dropped."""
    from PIL import Image, ImageOps, UnidentifiedImageError

    try:
        with Image.open(path) as img:
            return np.asarray(ImageOps.exif_transpose(img).convert("RGB"))
    except (UnidentifiedImageError, OSError) as e:
        raise ValueError(f"unreadable image: {path}") from e


def read_image_folder(folder: str | Path) -> np.ndarray:
    files = sorted(
        p for p in Path(folder).iterdir() if p.suffix.lower() in IMAGE_EXTS
    )
    if files and all(p.stem.isdigit() for p in files):
        # frame dumps use {i:03d}.png (reference convention) — clips with
        # 1000+ frames need numeric order, lexicographic puts 1000 < 999
        files.sort(key=lambda p: int(p.stem))
    frames = [_read_image(p) for p in files]
    if not frames:
        raise ValueError(f"no images in {folder}")
    return np.stack(frames).astype(np.float32) / 255.0


def load_sequence(path: str | Path) -> np.ndarray:
    """Folder of images, video file, or single image -> [F, H, W, 3] in [0,1]."""
    path = Path(path)
    if path.is_dir():
        return read_image_folder(path)
    if path.is_file():
        if is_video_file(path):
            return read_video_frames(path)
        if path.suffix.lower() in IMAGE_EXTS:
            return _read_image(path)[None].astype(np.float32) / 255.0
    raise ValueError(f"Unsupported input: {path}")


def _to_uint8(video: np.ndarray) -> np.ndarray:
    """[F, H, W, 3] float [0,1] (or already-uint8) -> uint8."""
    if video.dtype == np.uint8:
        return video
    return np.clip(video * 255.0, 0, 255).astype(np.uint8)


def is_i420(video: np.ndarray) -> bool:
    """Heuristic for packed planar I420 clips [F, H*3//2, W] uint8.

    A grayscale [F, H, W] uint8 clip can look identical — callers that know
    the format (the inference CLI knows the pipeline's output_i420 flag)
    should pass ``pixel_format`` to save_video explicitly; this shape check
    (plane height divisible by 3, frame dims even) is only the fallback."""
    if video.ndim != 3 or video.dtype != np.uint8:
        return False
    hp, w = video.shape[1], video.shape[2]
    return hp % 3 == 0 and (hp * 2 // 3) % 2 == 0 and w % 2 == 0


def i420_to_rgb(video: np.ndarray) -> np.ndarray:
    """[F, H*3//2, W] packed I420 uint8 -> [F, H, W, 3] RGB uint8 (cv2's
    BT.601 studio-swing I420 convention, matching the device-side encoder
    in DovePipeline)."""
    import cv2

    return np.stack(
        [cv2.cvtColor(f, cv2.COLOR_YUV2RGB_I420) for f in video]
    )


def save_frames_as_png(video: np.ndarray, out_dir: str | Path) -> None:
    """video: [F, H, W, 3] float [0,1]; writes 000.png, 001.png, ...
    (zlib level 1: lossless like any level, and faster to write than PIL's
    default level 6). Frames are encoded in threads (PIL's encoder releases
    the GIL); a failed write raises."""
    from concurrent.futures import ThreadPoolExecutor

    from PIL import Image

    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    frames = _to_uint8(video)

    def write(i: int) -> None:
        Image.fromarray(np.ascontiguousarray(frames[i])).save(
            out_dir / f"{i:03d}.png", compress_level=1)

    with ThreadPoolExecutor(max_workers=min(8, os.cpu_count() or 1)) as pool:
        list(pool.map(write, range(len(frames))))


def save_video(
    video: np.ndarray,
    out_path: str | Path,
    fps: int = 16,
    pixel_format: str | None = None,
) -> Path:
    """Encode [F, H, W, 3] float [0,1] (or packed I420 [F, H*3//2, W] uint8)
    to mp4 (best available OpenCV codec).

    pixel_format: "rgb" | "i420" | None (auto-detect via is_i420 — pass it
    explicitly when the clip could be grayscale). Returns the actual path
    written. Note: OpenCV cannot drive x264 CRF settings; for strictly
    lossless output use save_frames_as_png.
    """
    import cv2

    out_path = Path(out_path)
    out_path.parent.mkdir(parents=True, exist_ok=True)
    i420 = pixel_format == "i420" if pixel_format else is_i420(video)
    if i420:
        # packed planar YUV 4:2:0 straight from the device (pipeline
        # output_i420) — exactly what the H.264 encoder consumes anyway
        frames = video
        h, w = video.shape[1] * 2 // 3, video.shape[2]
        to_bgr = lambda f: cv2.cvtColor(f, cv2.COLOR_YUV2BGR_I420)
    else:
        frames = _to_uint8(video)
        h, w = frames.shape[1:3]
        to_bgr = lambda f: cv2.cvtColor(f, cv2.COLOR_RGB2BGR)
    global _MP4_FOURCC
    order = ("avc1", "mp4v")
    if _MP4_FOURCC:  # probe once per process
        order = (_MP4_FOURCC,) + tuple(c for c in order if c != _MP4_FOURCC)
    for fourcc_name in order:
        fourcc = cv2.VideoWriter_fourcc(*fourcc_name)
        # a failing codec probe (e.g. avc1 -> h264_v4l2m2m with no HW
        # device) spews C-level ffmpeg ERROR lines to fd 2 even though the
        # next fourcc succeeds — silence the PROBE only, never the writes
        with _quiet_stderr():
            writer = cv2.VideoWriter(str(out_path), fourcc, fps, (w, h))
            opened = writer.isOpened()
        if opened:
            if _MP4_FOURCC is None:
                _MP4_FOURCC = fourcc_name
                if fourcc_name != "avc1":
                    logger.info(
                        "avc1/H.264 encoder unavailable in this OpenCV "
                        "build; writing %s mp4s", fourcc_name,
                    )
            for frame in frames:
                writer.write(to_bgr(frame))
            writer.release()
            return out_path
        writer.release()
    raise RuntimeError("no working mp4 encoder in OpenCV build")


def save_video_lossless(
    video: np.ndarray, out_path: str | Path, fps: int = 16
) -> Path:
    """Strictly lossless video write: FFV1 in Matroska (the reference's
    lossless artifact, its inference_script.py:111-189), falling
    back to HuffYUV/AVI, then to a PNG frame directory.

    video: [F, H, W, 3] float [0,1] or uint8 RGB. Every codec in the chain
    round-trips BIT-EXACTLY (tests/test_cli_tools.py checks dove_tpu's copy); the PNG
    fallback only engages when the OpenCV build has no lossless encoder.
    Returns the path actually written (suffix may change with the codec).
    """
    import cv2

    out_path = Path(out_path)
    out_path.parent.mkdir(parents=True, exist_ok=True)
    frames = _to_uint8(video)
    h, w = frames.shape[1:3]
    for fourcc_name, suffix in (("FFV1", ".mkv"), ("HFYU", ".avi")):
        path = out_path.with_suffix(suffix)
        writer = cv2.VideoWriter(
            str(path), cv2.VideoWriter_fourcc(*fourcc_name), fps, (w, h)
        )
        if writer.isOpened():
            for frame in frames:
                writer.write(cv2.cvtColor(frame, cv2.COLOR_RGB2BGR))
            writer.release()
            if path.exists() and path.stat().st_size > 0:
                return path
        else:  # pragma: no cover - depends on the OpenCV build
            writer.release()
        path.unlink(missing_ok=True)
    # pragma: no cover - this build has FFV1; kept for portability
    save_frames_as_png(frames, out_path.with_suffix(""))
    return out_path.with_suffix("")


# the CLI's --upscale_mode names -> ops/resize.py's modes
UPSCALE_MODES = {
    "bilinear": "linear",
    "bicubic": "cubic",
    "nearest": "nearest",
    "area": "area",
    "lanczos": "lanczos4",
}


def bilinear_upscale(
    frames: np.ndarray, scale: int, mode: str = "bilinear"
) -> np.ndarray:
    """[F, H, W, 3] -> [F, H*s, W*s, 3]: what the JAX package's cv2.resize
    computes with the mode's interpolation (bilinear: half-pixel sampling),
    through ``ops/resize.py`` on the CPU, without OpenCV."""
    from dove_tpu_torch.ops.resize import resize

    if mode not in UPSCALE_MODES:
        raise ValueError(f"unknown upscale mode {mode!r}; one of {sorted(UPSCALE_MODES)}")
    if scale == 1:
        return frames
    F_, H, W, _ = frames.shape
    x = torch.from_numpy(np.ascontiguousarray(frames, np.float32))
    return resize(x, (H * scale, W * scale), UPSCALE_MODES[mode]).numpy().astype(
        frames.dtype, copy=False)


def list_videos(input_dir: str | Path) -> list[Path]:
    # filter by is_video_file (case-insensitive) rather than glob patterns:
    # camera files like CLIP.MP4 must not be silently skipped on Linux
    return sorted(
        p for p in Path(input_dir).iterdir()
        if p.is_file() and is_video_file(p)
    )
