"""Real-ESRGAN-style video degradation (LQ synthesis for training).

Counterpart of ``dove_tpu/data/degradation.py`` (after the reference's
finetune/datasets/degradation.py): per-clip random blur, resize, noise, JPEG
and video compression, with per-frame parameter drift (the ``*_step``
params) and order-shuffled groups, read from the reference's degradation
YAML by the port's own reader (``yaml_lite``; the machine with the card has
no PyYAML).

Every random draw is the JAX package's NumPy draw, from the generator the
dataset passes in and in the same order, so that one seed gives both
packages the same kernels, sizes, qualities, codecs and noise. The pixel
work is torch on [F, H, W, 3] float32 tensors in [0, 1] on the CPU (the
loader's workers), each op held to the OpenCV call it replaces:

* blur: ``cv2.filter2D`` with BORDER_REFLECT_101 -> a float64 FFT product
  over a reflect-101 border, one kernel for every channel (a frame's own
  kernel under drift);
* resize: ``cv2.resize`` -> ``ops/resize.py`` (bilinear -> linear, area,
  bicubic -> cubic, lanczos -> lanczos4);
* gray: ``cv2.COLOR_RGB2GRAY`` on float32 -> the same weighted sum in the
  fused multiply-add order of OpenCV's vector loop;
* JPEG: ``cv2.imencode`` / ``imdecode`` -> Pillow, whose libjpeg writes the
  same bytes at the same quality (the MJPEG fallback below too).

Video compression takes the JAX package's backend: an in-memory PyAV round
trip where ``av`` imports; otherwise a sampled ``mpeg4`` goes through
OpenCV's MPEG-4 Part 2 writer (imported when the op runs, and raising,
naming ROADMAP C.2, where OpenCV is missing, as on the card), and
``libx264`` / ``h264`` through the bitrate-targeted MJPEG round trip.
``compression_backend()`` says which.
"""

from __future__ import annotations

import io
import logging
import os
import tempfile
import threading
from pathlib import Path
from typing import Any, Sequence

import numpy as np
import torch

from dove_tpu_torch.data import blur_kernels as bk
from dove_tpu_torch.data import yaml_lite
from dove_tpu_torch.ops import resize as resize_op

logger = logging.getLogger(__name__)

_RESIZE_MODES = {
    "bilinear": "linear",
    "area": "area",
    "bicubic": "cubic",
    "lanczos": "lanczos4",
}
# OpenCV's float RGB -> gray weights (imgproc color.hpp, R2YF / G2YF / B2YF)
_GRAY_R, _GRAY_G, _GRAY_B = 0.299, 0.587, 0.114
# frames a blur's FFT takes at once (bounds its float64 buffers)
_FFT_FRAMES = 4


def _drift(rng, value, step, lo, hi):
    if not step:
        return value
    return float(np.clip(value + rng.uniform(-step, step), lo, hi))


def _reflect101(n: int, pad: int) -> torch.Tensor:
    """Source indices of a length-n axis padded by ``pad`` on each side with
    OpenCV's BORDER_REFLECT_101 (gfedcb|abcdefgh|gfedcba), at any pad."""
    idx = np.arange(-pad, n + pad)
    if n == 1:
        return torch.zeros(idx.shape, dtype=torch.long)
    period = 2 * (n - 1)
    idx = np.abs(idx) % period
    return torch.from_numpy(np.where(idx >= n, period - idx, idx))


def filter2d(frames: torch.Tensor, kernels: torch.Tensor) -> torch.Tensor:
    """``cv2.filter2D(frame, -1, kernel)`` of each frame: frames [F, H, W, 3]
    float32, kernels [k, k] (one for all frames) or [F, k, k] (a frame's
    own). Correlation, anchored at the centre, over a reflect-101 border,
    computed as a float64 FFT product a few frames at a time (what OpenCV
    does from 11x11 up; a direct convolution on the CPU takes ~3x the time
    and ~4x the memory at 21x21)."""
    Fn, H, W, C = frames.shape
    k = kernels.shape[-1]
    p = k // 2
    x = frames.permute(0, 3, 1, 2)  # [F, 3, H, W]
    x = x.index_select(2, _reflect101(H, p)).index_select(3, _reflect101(W, p))
    size = (H + 2 * p, W + 2 * p)
    # correlation = convolution with the flipped kernel; the valid part of the
    # circular product starts at 2p
    w = kernels.to(torch.float64).flip(-2, -1).reshape(-1, k, k)
    out = torch.empty((Fn, C, H, W), dtype=frames.dtype)
    for s in range(0, Fn, _FFT_FRAMES):
        e = min(s + _FFT_FRAMES, Fn)
        kf = torch.fft.rfft2(w if len(w) == 1 else w[s:e], s=size)[:, None]
        y = torch.fft.irfft2(torch.fft.rfft2(x[s:e].double()) * kf, s=size)
        out[s:e] = y[..., 2 * p:2 * p + H, 2 * p:2 * p + W]
    return out.permute(0, 2, 3, 1).contiguous()


def rgb_to_gray(frame: torch.Tensor) -> torch.Tensor:
    """[..., 3] float32 RGB -> [...] gray as ``cv2.cvtColor(COLOR_RGB2GRAY)``
    computes it on float32 in its vector loop: fma(b, wb, fma(r, wr, g *
    wg)), each fused step rounded once to float32 (a float64 product of two
    float32s is exact). The last pixels of a row whose width is not a
    multiple of OpenCV's vector width go through its scalar tail and may
    differ by one ulp."""
    r, g, b = (frame[..., i] for i in range(3))
    t = (g * _GRAY_G).double()
    t = (r.double() * torch.tensor(_GRAY_R, dtype=torch.float32).double() + t).float()
    return (b.double() * torch.tensor(_GRAY_B, dtype=torch.float32).double()
            + t.double()).float()


def _to_u8(frames: torch.Tensor) -> np.ndarray:
    """float [0, 1] -> uint8 as ``np.clip(f * 255, 0, 255).astype(np.uint8)``
    (truncation)."""
    return (frames * 255.0).clamp(0, 255).to(torch.uint8).numpy()


def _jpeg_encode(u8: np.ndarray, quality: int) -> bytes:
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(np.ascontiguousarray(u8)).save(buf, "JPEG", quality=quality)
    return buf.getvalue()


def _jpeg_decode(data: bytes) -> torch.Tensor:
    """JPEG bytes -> [H, W, 3] float32 in [0, 1]."""
    from PIL import Image

    with Image.open(io.BytesIO(data)) as img:
        u8 = np.asarray(img.convert("RGB"))
    return torch.from_numpy(u8.astype(np.float32) / 255.0)


class RandomBlur:
    """Per-frame blur with a (possibly drifting) random kernel."""

    def __init__(self, params: dict[str, Any]):
        self.p = params

    def __call__(self, frames: torch.Tensor, rng: np.random.Generator) -> torch.Tensor:
        p = self.p
        if rng.uniform() > p.get("prob", 1.0):
            return frames
        size = int(rng.choice(p["kernel_size"]))
        ktype = rng.choice(
            p["kernel_list"], p=np.asarray(p["kernel_prob"]) / np.sum(p["kernel_prob"])
        )
        sx = rng.uniform(*p.get("sigma_x", (0.2, 3.0)))
        sy = rng.uniform(*p.get("sigma_y", (0.2, 3.0)))
        th = rng.uniform(*p.get("rotate_angle", (-np.pi, np.pi)))
        bg = rng.uniform(*p.get("beta_gaussian", (0.5, 4.0)))
        bp = rng.uniform(*p.get("beta_plateau", (1.0, 2.0)))
        om = rng.uniform(*p.get("omega", (np.pi / 3, np.pi)))

        steps = {k: p.get(f"{k}_step", 0) for k in
                 ("sigma_x", "sigma_y", "rotate_angle", "beta_gaussian",
                  "beta_plateau", "omega")}
        drifting = any(steps.values())

        def make_kernel():
            if ktype == "iso":
                return bk.bivariate_gaussian(size, sx, isotropic=True)
            if ktype == "aniso":
                return bk.bivariate_gaussian(size, sx, sy, th, isotropic=False)
            if ktype == "generalized_iso":
                return bk.bivariate_generalized_gaussian(size, sx, None, 0.0, bg, True)
            if ktype == "generalized_aniso":
                return bk.bivariate_generalized_gaussian(size, sx, sy, th, bg, False)
            if ktype == "plateau_iso":
                return bk.bivariate_plateau(size, sx, None, 0.0, bp, True)
            if ktype == "plateau_aniso":
                return bk.bivariate_plateau(size, sx, sy, th, bp, False)
            if ktype == "sinc":
                return bk.circular_lowpass_kernel(om, size)
            raise ValueError(ktype)

        kernels = [make_kernel()]
        for _ in range(1, len(frames) if drifting else 1):
            sx = _drift(rng, sx, steps["sigma_x"], *p.get("sigma_x", (0.2, 3.0)))
            sy = _drift(rng, sy, steps["sigma_y"], *p.get("sigma_y", (0.2, 3.0)))
            th = _drift(rng, th, steps["rotate_angle"], -np.pi, np.pi)
            bg = _drift(rng, bg, steps["beta_gaussian"], *p.get("beta_gaussian", (0.5, 4.0)))
            bp = _drift(rng, bp, steps["beta_plateau"], *p.get("beta_plateau", (1.0, 2.0)))
            om = _drift(rng, om, steps["omega"], *p.get("omega", (np.pi / 3, np.pi)))
            kernels.append(make_kernel())
        k = torch.from_numpy(np.stack(kernels).astype(np.float32))
        return filter2d(frames, k if drifting else k[0])


class RandomResize:
    """Random up/down/keep rescale, or resize to a fixed target_size."""

    def __init__(self, params: dict[str, Any]):
        self.p = dict(params)
        self._cfg_target = self.p.get("target_size")
        # the per-crop override is thread-local, as in the JAX package, whose
        # loader threads share the ops: set-then-call within one __getitem__
        self._tl = threading.local()

    def __getstate__(self):  # worker processes get a copy, not the local
        return {k: v for k, v in self.__dict__.items() if k != "_tl"}

    def __setstate__(self, state):
        self.__dict__.update(state)
        self._tl = threading.local()

    @property
    def target_size(self) -> tuple[int, int] | None:
        return getattr(self._tl, "target_size", self._cfg_target)

    def set_target_size(self, hw: tuple[int, int]) -> None:
        """Datasets set the x(1/scale) LQ size per crop (thread-local: only
        this thread's next call sees it)."""
        self._tl.target_size = hw

    def __call__(self, frames: torch.Tensor, rng: np.random.Generator) -> torch.Tensor:
        p = self.p
        mode_name = rng.choice(p["resize_opt"],
                               p=np.asarray(p["resize_prob"]) / np.sum(p["resize_prob"]))
        Fn, H, W, _ = frames.shape
        if self.target_size is not None:
            th, tw = self.target_size
        else:
            mode = rng.choice(3, p=np.asarray(p["resize_mode_prob"]) /
                              np.sum(p["resize_mode_prob"]))
            lo, hi = p["resize_scale"]
            if mode == 0:  # up
                scale = rng.uniform(max(1.0, lo), max(1.0, hi))
            elif mode == 1:  # down
                scale = rng.uniform(min(1.0, lo), min(1.0, hi))
            else:
                scale = 1.0
            th, tw = int(round(H * scale)), int(round(W * scale))
            if p.get("is_size_even"):
                th, tw = max(2, th - th % 2), max(2, tw - tw % 2)
        if (th, tw) == (H, W):
            return frames
        return resize_op.resize(frames, (th, tw), _RESIZE_MODES[str(mode_name)])


class RandomNoise:
    """Gaussian or Poisson noise, optionally grayscale (channel-shared)."""

    def __init__(self, params: dict[str, Any]):
        self.p = params

    def __call__(self, frames: torch.Tensor, rng: np.random.Generator) -> torch.Tensor:
        p = self.p
        ntype = rng.choice(p["noise_type"],
                           p=np.asarray(p["noise_prob"]) / np.sum(p["noise_prob"]))
        out = torch.empty_like(frames)
        if ntype == "gaussian":
            sigma = rng.uniform(*p["gaussian_sigma"]) / 255.0
            step = p.get("gaussian_sigma_step", 0) / 255.0
            gray = rng.uniform() < p.get("gaussian_gray_noise_prob", 0.0)
            for i, f in enumerate(frames):
                if i > 0 and step:
                    sigma = _drift(rng, sigma, step,
                                   p["gaussian_sigma"][0] / 255.0,
                                   p["gaussian_sigma"][1] / 255.0)
                shape = tuple(f.shape[:2]) + ((1,) if gray else (3,))
                out[i] = f + torch.from_numpy(
                    rng.normal(0.0, sigma, shape).astype(np.float32))
        else:  # poisson
            scale = rng.uniform(*p["poisson_scale"])
            step = p.get("poisson_scale_step", 0)
            gray = rng.uniform() < p.get("poisson_gray_noise_prob", 0.0)
            for i, f in enumerate(frames):
                if i > 0 and step:
                    scale = _drift(rng, scale, step, *p["poisson_scale"])
                img = rgb_to_gray(f)[..., None] if gray else f
                # the reference's rate (degradation.py:286-292): round(img255)
                # times 2**ceil(log2(n_unique)), at the 0-255 scale. The draw's
                # count of uniforms depends on each rate, so every later draw
                # of the item depends on these pixels.
                base = torch.round(img * 255.0).clamp(0, 255).numpy()
                # len(np.unique(base)), counted on the 256 integer levels
                levels = np.count_nonzero(np.bincount(base.astype(np.int64).ravel(),
                                                      minlength=256))
                vals = 2 ** np.ceil(np.log2(levels))
                noisy = rng.poisson(base * vals) / vals
                noise = (noisy - base).astype(np.float32) * scale / 255.0
                out[i] = f + torch.from_numpy(noise)
        return out.clamp(0.0, 1.0)


class RandomJPEGCompression:
    """Per-frame JPEG encode/decode round trip with quality drift."""

    def __init__(self, params: dict[str, Any]):
        self.p = params

    def __call__(self, frames: torch.Tensor, rng: np.random.Generator) -> torch.Tensor:
        lo, hi = self.p["quality"]
        q = rng.uniform(lo, hi)
        step = self.p.get("quality_step", 0)
        out = torch.empty_like(frames)
        u8 = _to_u8(frames)
        for i in range(len(frames)):
            if i > 0 and step:
                q = _drift(rng, q, step, lo, hi)
            out[i] = _jpeg_decode(_jpeg_encode(u8[i], int(round(q))))
        return out


def _have(module: str) -> bool:
    try:
        __import__(module)
        return True
    except ImportError:
        return False


_BACKEND_WARNED = False


def compression_backend() -> str:
    """Which backend RandomVideoCompression uses here, as the JAX package
    names it ("pyav" or "cv2-mp4v+rate-mjpeg-fallback"); where OpenCV is
    missing too (the card), "rate-mjpeg-fallback, mpeg4 raises (C.2)". The
    trainer records it in train_log.jsonl."""
    if _have("av"):
        return "pyav"
    if _have("cv2"):
        return "cv2-mp4v+rate-mjpeg-fallback"
    return "rate-mjpeg-fallback, mpeg4 raises (C.2)"


def _warn_fallback_once() -> None:
    global _BACKEND_WARNED
    if _BACKEND_WARNED:
        return
    _BACKEND_WARNED = True
    logger.warning(
        "PyAV is not importable: RandomVideoCompression falls back as the "
        "JAX package does: a sampled mpeg4 round-trips through OpenCV's "
        "MPEG-4 Part 2 writer (no rate control; raises where OpenCV is "
        "missing, ROADMAP C.2), libx264/h264 through a bitrate-targeted "
        "MJPEG (intra-only). video_compression_backend=%s is recorded in "
        "train_log.jsonl.", compression_backend())


class RandomVideoCompression:
    """Video codec round trip (temporal compression artifacts)."""

    def __init__(self, params: dict[str, Any]):
        self.p = params

    def __call__(self, frames: torch.Tensor, rng: np.random.Generator) -> torch.Tensor:
        p = self.p
        codec = rng.choice(p["codec"],
                           p=np.asarray(p["codec_prob"]) / np.sum(p["codec_prob"]))
        bitrate = int(rng.uniform(*p["bitrate"]))
        if _have("av"):
            return self._av_roundtrip(frames, str(codec), bitrate)
        _warn_fallback_once()
        if str(codec) == "mpeg4":
            return self._cv2_roundtrip(frames, bitrate)
        return self._mjpeg_roundtrip(frames, bitrate)

    def _mjpeg_roundtrip(self, frames: torch.Tensor, bitrate, fps: float = 25.0,
                         return_bytes: bool = False):
        """Bitrate-targeted intra-only (MJPEG) round trip: one JPEG quality
        for the whole clip, binary-searched so that the encoded size meets
        the sampled bitrate; decoded per frame."""
        Fn = frames.shape[0]
        target_bytes = max(int(bitrate / 8.0 * (Fn / fps)), Fn * 64)
        u8 = _to_u8(frames)

        def encode_all(q: int) -> list[bytes]:
            return [_jpeg_encode(f, q) for f in u8]

        lo, hi = 2, 95
        best = encode_all(lo)  # even q=2 may exceed tiny targets: keep it
        while lo < hi:
            mid = (lo + hi + 1) // 2
            bufs = encode_all(mid)
            if sum(len(b) for b in bufs) <= target_bytes:
                best, lo = bufs, mid
            else:
                hi = mid - 1
        out = torch.stack([_jpeg_decode(b) for b in best])
        if return_bytes:
            return out, sum(len(b) for b in best)
        return out

    def _av_roundtrip(self, frames: torch.Tensor, codec, bitrate):
        import av

        Fn, H, W, _ = frames.shape
        pad_h, pad_w = H % 2, W % 2
        buf = io.BytesIO()
        with av.open(buf, mode="w", format="mp4") as container:
            stream = container.add_stream(codec, rate=25)
            stream.height = H + pad_h
            stream.width = W + pad_w
            stream.pix_fmt = "yuv420p"
            stream.bit_rate = bitrate
            for u8 in _to_u8(frames):
                if pad_h or pad_w:
                    u8 = np.pad(u8, ((0, pad_h), (0, pad_w), (0, 0)), mode="edge")
                frame = av.VideoFrame.from_ndarray(u8, format="rgb24")
                for pkt in stream.encode(frame):
                    container.mux(pkt)
            for pkt in stream.encode(None):
                container.mux(pkt)
        buf.seek(0)
        out = []
        with av.open(buf, mode="r") as container:
            for frame in container.decode(video=0):
                arr = frame.to_ndarray(format="rgb24")
                out.append(arr[:H, :W].astype(np.float32) / 255.0)
        if not out:
            logger.warning("av %s round-trip decoded 0 frames; passing frames "
                           "through", codec)
            return frames
        if len(out) < Fn:  # decoder returned short; repeat last
            out.extend([out[-1]] * (Fn - len(out)))
        return torch.from_numpy(np.stack(out[:Fn]))

    def _cv2_roundtrip(self, frames: torch.Tensor, bitrate):
        try:
            import cv2
        except ImportError:
            raise RuntimeError(
                "the sampled mpeg4 codec round-trips through OpenCV's MPEG-4 "
                "writer, and this machine has neither PyAV nor OpenCV "
                "(ROADMAP C.2); move mpeg4's codec_prob to libx264/h264 (the "
                "MJPEG fallback) to train here") from None
        Fn, H, W, _ = frames.shape
        pad_h, pad_w = H % 2, W % 2
        with tempfile.TemporaryDirectory() as d:
            path = os.path.join(d, "clip.mp4")
            writer = cv2.VideoWriter(
                path, cv2.VideoWriter_fourcc(*"mp4v"), 25, (W + pad_w, H + pad_h))
            # map bitrate [1e4, 1e5] onto the quality knob where supported
            q = np.interp(bitrate, [1e4, 1e5], [20.0, 90.0])
            try:
                writer.set(cv2.VIDEOWRITER_PROP_QUALITY, float(q))
            except cv2.error:
                pass
            for u8 in _to_u8(frames):
                if pad_h or pad_w:
                    u8 = np.pad(u8, ((0, pad_h), (0, pad_w), (0, 0)), mode="edge")
                writer.write(cv2.cvtColor(u8, cv2.COLOR_RGB2BGR))
            writer.release()
            cap = cv2.VideoCapture(path)
            out = []
            while True:
                ok, frame = cap.read()
                if not ok:
                    break
                rgb = cv2.cvtColor(frame, cv2.COLOR_BGR2RGB)
                out.append(rgb[:H, :W].astype(np.float32) / 255.0)
            cap.release()
        if not out:
            logger.warning("video-compression round-trip decoded 0 frames (no "
                           "usable codec in this OpenCV build); passing frames "
                           "through")
            return frames
        if len(out) < Fn:  # codec dropped frames; repeat last
            out.extend([out[-1]] * (Fn - len(out)))
        return torch.from_numpy(np.stack(out[:Fn]))


_OP_TYPES = {
    "RandomBlur": RandomBlur,
    "RandomResize": RandomResize,
    "RandomNoise": RandomNoise,
    "RandomJPEGCompression": RandomJPEGCompression,
    "RandomVideoCompression": RandomVideoCompression,
}

_KEY_TO_TYPE = {
    "random_blur": RandomBlur,
    "random_resize": RandomResize,
    "random_noise": RandomNoise,
    "random_jpeg": RandomJPEGCompression,
    "random_mpeg": RandomVideoCompression,
}


def _build_op(spec: dict[str, Any]):
    return _OP_TYPES[spec["type"]](spec.get("params", {}))


class DegradationsWithShuffle:
    """Apply a list of degradations (or nested sub-lists) in shuffled order."""

    def __init__(self, degradations: Sequence[Any]):
        self.groups = []
        for item in degradations:
            if isinstance(item, list):
                self.groups.append([_build_op(s) for s in item])
            else:
                self.groups.append([_build_op(item)])

    def __call__(self, frames: torch.Tensor, rng: np.random.Generator) -> torch.Tensor:
        order = rng.permutation(len(self.groups))
        for gi in order:
            for op in self.groups[gi]:
                frames = op(frames, rng)
        return frames

    def set_target_size(self, hw: tuple[int, int]) -> bool:
        """Point the shuffled resize at the per-crop LQ size (the datasets set
        it to crop / scale for each item)."""
        for group in self.groups:
            for op in group:
                if isinstance(op, RandomResize):
                    op.set_target_size(hw)
                    return True
        return False


class DegradationPipeline:
    """One degradation stage parsed from a reference-format YAML section."""

    def __init__(self, section: dict[str, Any]):
        self.keyed_ops: list[tuple[str, Any]] = []
        for key, spec in section.items():
            if key == "degradation_with_shuffle":
                self.keyed_ops.append(
                    (key, DegradationsWithShuffle(spec["degradations"])))
            elif key in _KEY_TO_TYPE:
                self.keyed_ops.append((key, _KEY_TO_TYPE[key](spec.get("params", {}))))
            else:
                raise ValueError(f"unknown degradation op: {key}")

    @property
    def ops(self) -> list[Any]:
        return [op for _, op in self.keyed_ops]

    def find_resize(self):
        for op in self.ops:
            if isinstance(op, RandomResize):
                return op
        return None

    def set_shuffle_target_size(self, hw: tuple[int, int]) -> bool:
        """Set the dynamic LQ size on the resize inside the shuffle group."""
        for op in self.ops:
            if isinstance(op, DegradationsWithShuffle) and op.set_target_size(hw):
                return True
        return False

    def __call__(
        self,
        frames: torch.Tensor,
        rng: np.random.Generator,
        skip: Sequence[str] = (),
        only: Sequence[str] | None = None,
    ) -> torch.Tensor:
        """Run the stage on [F, H, W, 3] float32 in [0, 1]. ``skip`` /
        ``only`` filter by op key (the stage-2 image branch skips MPEG)."""
        for key, op in self.keyed_ops:
            if key in skip:
                continue
            if only is not None and key not in only:
                continue
            frames = op(frames, rng)
        return frames


def load_degradation_config(path: str | Path) -> dict[str, DegradationPipeline]:
    """Parse a reference-format degradation YAML into named stages."""
    raw = yaml_lite.safe_load(Path(path).read_text())
    return {name: DegradationPipeline(section) for name, section in raw.items()}
