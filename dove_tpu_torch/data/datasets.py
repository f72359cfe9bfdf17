"""Training datasets: paired HQ/LQ clips with on-the-fly degradation.

Counterpart of ``dove_tpu/data/datasets.py`` (after the reference's
finetune/datasets/real_sr_dataset.py and real_sr_image_video_dataset.py):

* ``RealSRDataset``, stage 1: decode up to max_frames + 10 frames, a random
  spatio-temporal crop to 1.5x the target resolution rounded up to 16, the
  two-stage degradation with the shuffled resize pointed at crop / 4, an
  aligned random crop (LQ at 1/4, HQ at full size), the LQ bilinear-resized
  back to HQ size, both mapped to [-1, 1];
* ``RealSRImageVideoDataset``, stage 2: also an image pair per item (images
  skip MPEG and take a fixed third stage), the video list repeated to the
  image count;
* ``BucketSampler``: batches of one (F, H, W) geometry;
* the prompt-embedding cache keyed by the prompt's SHA-256 and the latent
  cache keyed by (model, resolution), in the reference's
  ``data_root/cache/...`` safetensors layout, read and written through the
  port's ``safetensors_io`` (the card has no ``safetensors``), each write
  atomic (a temp file, then a rename).

An item draws from ``np.random.default_rng((seed, epoch, index))`` in the JAX
package's order, so both packages give the same crops and degradations.
Images are read through Pillow; video files through OpenCV, imported when a
clip is read (the card has no OpenCV: a video file raises there, naming
ROADMAP C.2, and the card's data are image files and frame folders).
Items are NumPy float32 arrays [F, H, W, 3].
"""

from __future__ import annotations

import hashlib
import math
import os
import tempfile
from pathlib import Path
from typing import Any, Sequence

import numpy as np
import torch

from dove_tpu_torch import safetensors_io
from dove_tpu_torch.data.degradation import load_degradation_config
from dove_tpu_torch.io import video as video_io
from dove_tpu_torch.ops import resize as resize_op

EMPTY_PROMPT_SHA = (
    "e3b0c44298fc1c149afbf4c8996fb92427ae41e4649b934ca495991b7852b855"
)


# ---------------------------------------------------------------------------
# Manifest / media loading helpers
# ---------------------------------------------------------------------------

def load_manifest(manifest: str | Path, root: str | Path | None = None) -> list[Path]:
    """Read a txt manifest of relative media paths (one per line)."""
    root = Path(root) if root is not None else Path(".")
    lines = [
        ln.strip() for ln in Path(manifest).read_text().splitlines() if ln.strip()
    ]
    return [root / ln for ln in lines]


def load_prompts(path: str | Path) -> list[str]:
    return [ln.strip() for ln in Path(path).read_text().splitlines()]


def read_clip(path: str | Path, max_frames: int) -> torch.Tensor:
    """Decode up to max_frames frames -> [F, H, W, 3] float32 in [0, 1]."""
    path = Path(path)
    if path.suffix.lower() in video_io.IMAGE_EXTS:
        img = video_io._read_image(path)
        return torch.from_numpy(img[None].astype(np.float32) / 255.0)
    try:
        import cv2
    except ImportError:
        raise RuntimeError(
            f"{path}: video files are decoded through OpenCV, which this machine "
            "lacks (ROADMAP C.2); give the dataset image files") from None
    cap = cv2.VideoCapture(str(path))
    frames = []
    while len(frames) < max_frames:
        ok, frame = cap.read()
        if not ok:
            break
        frames.append(cv2.cvtColor(frame, cv2.COLOR_BGR2RGB))
    cap.release()
    if not frames:
        raise ValueError(f"no frames decoded from {path}")
    return torch.from_numpy(np.stack(frames).astype(np.float32) / 255.0)


# ---------------------------------------------------------------------------
# Crop / resize primitives
# ---------------------------------------------------------------------------

def random_crop_clip(
    frames: torch.Tensor, num_frames: int, height: int, width: int,
    rng: np.random.Generator,
) -> torch.Tensor:
    """Random temporal window and spatial crop; a request larger than the
    source shrinks to it."""
    F, H, W, _ = frames.shape
    nf = min(num_frames, F)
    h = min(height, H)
    w = min(width, W)
    t0 = int(rng.integers(0, F - nf + 1))
    y0 = int(rng.integers(0, H - h + 1))
    x0 = int(rng.integers(0, W - w + 1))
    return frames[t0 : t0 + nf, y0 : y0 + h, x0 : x0 + w]


def paired_random_crop(
    hq: torch.Tensor,
    lq: torch.Tensor,
    max_frames: int,
    lq_h: int,
    lq_w: int,
    scale: int,
    rng: np.random.Generator,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Aligned random crop: LQ at (lq_h, lq_w), HQ at scale x that, same offset
    (reference: finetune/datasets/utils.py paired_random_crop_video)."""
    Fh, Hh, Wh, _ = hq.shape
    Fl, Hl, Wl, _ = lq.shape
    if Hh != Hl * scale or Wh != Wl * scale:
        raise ValueError(f"HQ {Hh}x{Wh} is not {scale}x the LQ {Hl}x{Wl}")
    lq_h, lq_w = min(lq_h, Hl), min(lq_w, Wl)
    nf = min(max_frames, Fh, Fl)
    t0 = int(rng.integers(0, min(Fh, Fl) - nf + 1))
    y0 = int(rng.integers(0, Hl - lq_h + 1))
    x0 = int(rng.integers(0, Wl - lq_w + 1))
    lq_c = lq[t0 : t0 + nf, y0 : y0 + lq_h, x0 : x0 + lq_w]
    hq_c = hq[
        t0 : t0 + nf,
        y0 * scale : (y0 + lq_h) * scale,
        x0 * scale : (x0 + lq_w) * scale,
    ]
    return hq_c, lq_c


def resize_clip(frames: torch.Tensor, height: int, width: int) -> torch.Tensor:
    """Bilinear per-frame resize of [F, H, W, 3] (cv2.INTER_LINEAR)."""
    return resize_op.resize(frames, (height, width), "linear")


# ---------------------------------------------------------------------------
# Caches (reference-compatible safetensors layout)
# ---------------------------------------------------------------------------

def prompt_hash(prompt: str) -> str:
    return hashlib.sha256(prompt.encode()).hexdigest()


def _load_safetensor(path: Path, key: str) -> np.ndarray | None:
    if not path.exists():
        return None
    tensors = safetensors_io.load_file(path)
    t = tensors[key] if key in tensors else next(iter(tensors.values()))
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def _save_safetensor(path: Path, key: str, value: np.ndarray) -> None:
    """Atomic write (a temp file, then a rename), so that concurrent fills of
    one entry never leave a torn file."""
    path.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=path.parent, suffix=".tmp")
    os.close(fd)
    try:
        safetensors_io.save_file({key: np.ascontiguousarray(value)}, tmp)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


# ---------------------------------------------------------------------------
# Stage-1 dataset
# ---------------------------------------------------------------------------

class RealSRDataset(torch.utils.data.Dataset):
    """Paired HQ/LQ video clips with two-stage on-the-fly degradation.

    Returns per item:
      hq_video, lq_video: [F, H, W, 3] float32 in [-1, 1] (LQ resized back to
      HQ size, the reference's x4 bilinear before the model);
      prompt, prompt_embedding (np or None); or, with is_latent, the cached
      hq_latent / lq_latent instead of the clips.
    """

    def __init__(
        self,
        data_root: str | Path,
        video_manifest: str | Path,
        max_num_frames: int,
        height: int,
        width: int,
        degradation_config: str | Path,
        *,
        caption_manifest: str | Path | None = None,
        scale: int = 4,
        empty_ratio: float = 1.0,
        cache_prompts: bool = True,
        prompt_cache: str = "prompt_embeddings",
        encode_text=None,  # callable prompt -> np [L, D]; None = cache-only
        is_latent: bool = False,
        encode_video=None,  # callable [F,H,W,3] in [-1,1] -> latent np array
        model_name: str = "model",
        seed: int = 0,
    ) -> None:
        self.data_root = Path(data_root)
        self.videos = load_manifest(video_manifest, self.data_root)
        missing = [p for p in self.videos if not p.is_file()]
        if missing:
            raise ValueError(f"missing video files, e.g. {missing[0]}")
        if caption_manifest is None:
            self.prompts = [""] * len(self.videos)
        else:
            self.prompts = load_prompts(caption_manifest)
            if len(self.prompts) != len(self.videos):
                raise ValueError(
                    f"{len(self.prompts)} prompts != {len(self.videos)} videos")

        self.max_num_frames = max_num_frames
        self.height = height
        self.width = width
        self.scale = scale
        self.empty_ratio = empty_ratio
        self.cache_prompts = cache_prompts
        self.encode_text = encode_text
        self._seed = seed
        self._epoch = 0

        self.stages = load_degradation_config(degradation_config)

        # the reference's sizing rules (real_sr_dataset.py:92-102)
        if "youhq" in str(video_manifest).lower():
            self.inter_frames = min(max_num_frames + 10, 30)
        else:
            self.inter_frames = max_num_frames + 10
        self.inter_height = math.ceil((height * 1.5) / 16) * 16
        self.inter_width = math.ceil((width * 1.5) / 16) * 16
        self.target_h = height // scale
        self.target_w = width // scale

        self.prompt_cache_dir = self.data_root / "cache" / prompt_cache
        self.empty_prompt = _load_safetensor(
            self.prompt_cache_dir / f"{EMPTY_PROMPT_SHA}.safetensors",
            "prompt_embedding",
        )

        # the latent cache (reference layout: data_root/cache/video_latent/
        # {hq,lq}/<model>/<FxHxW>/<stem>.safetensors) freezes one degradation
        # draw per clip, as in the reference
        self.is_latent = is_latent
        self.encode_video = encode_video
        res_str = f"{max_num_frames}x{height}x{width}"
        self.latent_dirs = {
            kind: self.data_root / "cache" / "video_latent" / kind
            / model_name / res_str
            for kind in ("hq", "lq")
        }

    def __len__(self) -> int:
        return len(self.videos)

    def set_epoch(self, epoch: int) -> None:
        """Fold the epoch into the per-item generators: each epoch draws fresh
        degradations, deterministically."""
        self._epoch = epoch

    def _rng(self, index: int) -> np.random.Generator:
        # (seed, epoch, index): fresh draws each epoch, and a resumed run
        # replays the same data stream
        return np.random.default_rng((self._seed, self._epoch, index))

    # -- degradation --------------------------------------------------------

    def _degrade(self, frames: torch.Tensor, rng: np.random.Generator) -> torch.Tensor:
        crop_h, crop_w = frames.shape[1], frames.shape[2]
        stage2 = self.stages["degradation_2"]
        stage2.set_shuffle_target_size((crop_h // self.scale, crop_w // self.scale))
        lq = self.stages["degradation_1"](frames, rng)
        return stage2(lq, rng)

    # -- prompt embedding ----------------------------------------------------

    def _prompt_embedding(self, prompt: str) -> tuple[str, np.ndarray | None]:
        if self.empty_prompt is not None and prompt == "":
            return prompt, self.empty_prompt
        path = self.prompt_cache_dir / f"{prompt_hash(prompt)}.safetensors"
        emb = _load_safetensor(path, "prompt_embedding")
        if emb is None and self.encode_text is not None:
            emb = np.asarray(self.encode_text(prompt))
            if self.cache_prompts:
                _save_safetensor(path, "prompt_embedding", emb)
        if emb is None and prompt != "":
            # a real prompt with neither a cache entry nor an encoder fails
            # here; the empty prompt stays None and the trainer substitutes
            # its own embedding
            raise RuntimeError(
                f"no cached embedding for prompt {prompt[:60]!r} (expected "
                f"{path}) and no encode_text fn: precompute the cache, or train "
                "with empty_prompt / empty_ratio=1.0")
        return prompt, emb

    # -- item ----------------------------------------------------------------

    def _paired_clip(
        self, path: Path, rng: np.random.Generator,
        inter_frames: int | None = None, max_frames: int | None = None,
        image_mode: bool = False,
    ) -> tuple[np.ndarray, np.ndarray]:
        inter_frames = inter_frames or self.inter_frames
        max_frames = max_frames or self.max_num_frames
        frames = self.read_clip(path, inter_frames)
        crop = random_crop_clip(
            frames, inter_frames, self.inter_height, self.inter_width, rng)
        # keep the crop divisible by the scale (sources under 1.5x target)
        ch = crop.shape[1] - crop.shape[1] % (self.scale * 2)
        cw = crop.shape[2] - crop.shape[2] % (self.scale * 2)
        crop = crop[:, :ch, :cw]

        if image_mode:
            stage3 = self.stages["degradation_3"]
            resize3 = stage3.find_resize()
            if resize3 is not None:
                resize3.set_target_size((ch // self.scale, cw // self.scale))
            lq = self.stages["degradation_1"](crop, rng, skip=("random_mpeg",))
            lq = self.stages["degradation_2"](
                lq, rng, skip=("degradation_with_shuffle",))
            lq = stage3(lq, rng)
        else:
            lq = self._degrade(crop, rng)

        hq_c, lq_c = paired_random_crop(
            crop, lq, max_frames, self.target_h, self.target_w, self.scale, rng)
        lq_up = resize_clip(lq_c, hq_c.shape[1], hq_c.shape[2])
        return (
            (hq_c.clamp(0, 1) * 2.0 - 1.0).contiguous().numpy(),
            (lq_up.clamp(0, 1) * 2.0 - 1.0).contiguous().numpy(),
        )

    def read_clip(self, path: Path, max_frames: int) -> torch.Tensor:
        """The source frames of a manifest entry (a subclass may supply its
        own)."""
        return read_clip(path, max_frames)

    def _latent_paths(self, index: int) -> dict[str, Path]:
        stem = self.videos[index].stem
        return {k: d / f"{stem}.safetensors" for k, d in self.latent_dirs.items()}

    def fill_latent_cache(self) -> int:
        """Encode and cache every item whose latents are missing, in this
        process at the current epoch (a single-threaded pre-pass, as the
        reference's precompute: the encode runs on the card, which loader
        worker processes cannot use). Returns the number of items encoded."""
        if self.encode_video is None:
            raise RuntimeError("fill_latent_cache needs an encode_video fn")
        todo = [i for i in range(len(self))
                if not all(p.exists() for p in self._latent_paths(i).values())]
        for i in todo:
            self[i]
        return len(todo)

    def __getitem__(self, index: int) -> dict[str, Any]:
        rng = self._rng(index)
        prompt = self.prompts[index]
        if rng.uniform() < self.empty_ratio:
            prompt = ""
        prompt, emb = self._prompt_embedding(prompt)

        if self.is_latent:
            paths = self._latent_paths(index)
            hq_lat = _load_safetensor(paths["hq"], "latent")
            lq_lat = _load_safetensor(paths["lq"], "latent")
            if hq_lat is None or lq_lat is None:
                if self.encode_video is None:
                    raise RuntimeError(
                        "is_latent=True but no cached latents and no encode_video "
                        "fn (run the precompute pass first)")
                hq, lq = self._paired_clip(self.videos[index], rng)
                hq_lat = np.asarray(self.encode_video(hq))
                lq_lat = np.asarray(self.encode_video(lq))
                _save_safetensor(paths["hq"], "latent", hq_lat)
                _save_safetensor(paths["lq"], "latent", lq_lat)
            return {
                "prompt": prompt,
                "prompt_embedding": emb,
                "hq_latent": hq_lat,
                "lq_latent": lq_lat,
            }

        hq, lq = self._paired_clip(self.videos[index], rng)
        return {
            "prompt": prompt,
            "prompt_embedding": emb,
            "hq_video": hq,
            "lq_video": lq,
            "video_metadata": {
                "num_frames": hq.shape[0],
                "height": hq.shape[1],
                "width": hq.shape[2],
            },
        }


# ---------------------------------------------------------------------------
# Stage-2 dataset: parallel image + video branches
# ---------------------------------------------------------------------------

class RealSRImageVideoDataset(RealSRDataset):
    """Adds a DIV2K-style image branch: each item returns both a video pair
    and a single-frame image pair (reference: real_sr_image_video_dataset.py)."""

    def __init__(
        self,
        data_root: str | Path,
        video_manifest: str | Path,
        max_num_frames: int,
        height: int,
        width: int,
        degradation_config: str | Path,
        *,
        image_data_root: str | Path | None = None,
        image_manifest: str | Path | None = None,
        **kwargs,
    ) -> None:
        super().__init__(
            data_root, video_manifest, max_num_frames, height, width,
            degradation_config, **kwargs,
        )
        if image_manifest is None:
            raise ValueError("RealSRImageVideoDataset needs image_manifest")
        self.images = load_manifest(
            image_manifest, image_data_root if image_data_root else data_root)
        if len(self.images) > len(self.videos):
            times = math.ceil(len(self.images) / len(self.videos))
            self.videos = (self.videos * times)[: len(self.images)]
            self.prompts = (self.prompts * times)[: len(self.images)]
        if "degradation_3" not in self.stages:
            raise ValueError(
                "stage-2 training needs a degradation_3 section (image branch)")

    def __getitem__(self, index: int) -> dict[str, Any]:
        rng = self._rng(index)
        prompt = self.prompts[index]
        if rng.uniform() < self.empty_ratio:
            prompt = ""
        prompt, emb = self._prompt_embedding(prompt)
        hq_v, lq_v = self._paired_clip(self.videos[index], rng)
        img_path = self.images[index % len(self.images)]
        hq_i, lq_i = self._paired_clip(
            img_path, rng, inter_frames=1, max_frames=1, image_mode=True)
        return {
            "prompt": prompt,
            "prompt_embedding": emb,
            "hq_video": hq_v,
            "lq_video": lq_v,
            "hq_image": hq_i,
            "lq_image": lq_i,
            "video_metadata": {
                "num_frames": hq_v.shape[0],
                "height": hq_v.shape[1],
                "width": hq_v.shape[2],
            },
        }


# ---------------------------------------------------------------------------
# Bucket sampler (geometry-homogeneous batches)
# ---------------------------------------------------------------------------

class BucketSampler:
    """Batches of indices whose samples share (F, H, W) geometry (reference:
    finetune/datasets/bucket_sampler.py); shuffled from (seed, epoch)."""

    def __init__(
        self,
        shapes: Sequence[tuple[int, int, int]],
        batch_size: int,
        shuffle: bool = True,
        drop_last: bool = False,
        seed: int = 0,
    ) -> None:
        self.shapes = list(shapes)
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.seed = seed
        self._epoch = 0

    def set_epoch(self, epoch: int) -> None:
        self._epoch = epoch

    def __iter__(self):
        rng = np.random.default_rng((self.seed, self._epoch))
        order = np.arange(len(self.shapes))
        if self.shuffle:
            rng.shuffle(order)
        buckets: dict[tuple[int, int, int], list[int]] = {}
        for idx in order:
            b = buckets.setdefault(self.shapes[idx], [])
            b.append(int(idx))
            if len(b) == self.batch_size:
                yield list(b)
                b.clear()
        for b in buckets.values():
            if b and not self.drop_last:
                yield list(b)

    def __len__(self) -> int:
        # per bucket: items of different shapes never share a batch
        counts: dict[tuple[int, int, int], int] = {}
        for s in self.shapes:
            counts[s] = counts.get(s, 0) + 1
        if self.drop_last:
            return sum(c // self.batch_size for c in counts.values())
        return sum(math.ceil(c / self.batch_size) for c in counts.values())
