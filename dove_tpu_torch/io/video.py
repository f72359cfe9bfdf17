"""Host-side media I/O (decode/encode) for the VSR pipeline.

A copy of ``dove_tpu/io/video.py`` built on OpenCV, with ``cv2`` imported
inside the functions that use it: a machine without OpenCV can import the
port and run everything that does not read or write media files. Lossless
output falls back to PNG sequences when no lossless video codec is available
through OpenCV.
"""

from __future__ import annotations

import contextlib
import logging
import os
import sys
from pathlib import Path

import numpy as np

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


def read_image_folder(folder: str | Path) -> np.ndarray:
    import cv2

    files = sorted(
        p for p in Path(folder).iterdir() if p.suffix.lower() in IMAGE_EXTS
    )
    if files and all(p.stem.isdigit() for p in files):
        # frame dumps use {i:03d}.png (reference convention) — clips with
        # 1000+ frames need numeric order, lexicographic puts 1000 < 999
        files.sort(key=lambda p: int(p.stem))
    frames = []
    for p in files:
        img = cv2.imread(str(p), cv2.IMREAD_COLOR)
        if img is None:  # imread never raises — name the offending file
            raise ValueError(f"unreadable image: {p}")
        frames.append(cv2.cvtColor(img, cv2.COLOR_BGR2RGB))
    if not frames:
        raise ValueError(f"no images in {folder}")
    return np.stack(frames).astype(np.float32) / 255.0


def load_sequence(path: str | Path) -> np.ndarray:
    """Folder of images, video file, or single image -> [F, H, W, 3] in [0,1]."""
    import cv2

    path = Path(path)
    if path.is_dir():
        return read_image_folder(path)
    if path.is_file():
        if is_video_file(path):
            return read_video_frames(path)
        if path.suffix.lower() in IMAGE_EXTS:
            raw = cv2.imread(str(path), cv2.IMREAD_COLOR)
            if raw is None:  # imread never raises — name the offending file
                raise ValueError(f"unreadable image: {path}")
            img = cv2.cvtColor(raw, cv2.COLOR_BGR2RGB)
            return img[None].astype(np.float32) / 255.0
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
    """video: [F, H, W, 3] float [0,1]; writes 000.png, 001.png, ..."""
    import cv2

    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    for i, frame in enumerate(_to_uint8(video)):
        cv2.imwrite(str(out_dir / f"{i:03d}.png"), cv2.cvtColor(frame, cv2.COLOR_RGB2BGR))


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


# cv2 interpolation flag names, resolved inside bilinear_upscale
_UPSCALE_MODES = {
    "bilinear": "INTER_LINEAR",
    "bicubic": "INTER_CUBIC",
    "nearest": "INTER_NEAREST",
    "area": "INTER_AREA",
    "lanczos": "INTER_LANCZOS4",
}


def bilinear_upscale(
    frames: np.ndarray, scale: int, mode: str = "bilinear"
) -> np.ndarray:
    """[F, H, W, 3] -> [F, H*s, W*s, 3]; half-pixel sampling (matches
    torch.nn.functional.interpolate(..., align_corners=False))."""
    import cv2

    if scale == 1:
        return frames
    interp = getattr(cv2, _UPSCALE_MODES[mode])
    F, H, W, _ = frames.shape
    out = np.empty((F, H * scale, W * scale, frames.shape[3]), dtype=frames.dtype)
    for i in range(F):
        out[i] = cv2.resize(frames[i], (W * scale, H * scale), interpolation=interp)
    return out


def list_videos(input_dir: str | Path) -> list[Path]:
    # filter by is_video_file (case-insensitive) rather than glob patterns:
    # camera files like CLIP.MP4 must not be silently skipped on Linux
    return sorted(
        p for p in Path(input_dir).iterdir()
        if p.is_file() and is_video_file(p)
    )
