"""Host-side frame and chunk geometry of the staged path (NumPy).

A copy of what the staged pipeline uses from ``dove_tpu/tiling.py``: the
pre-pipeline padding rules, the causal-VAE frame rule, the overlapping
temporal chunk plan and its half-overlap trim, and the I420 crop.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class Tile:
    """One unit of work: a (time, height, width) window into the padded video."""

    t_start: int
    t_end: int
    h_start: int
    h_end: int
    w_start: int
    w_end: int


@dataclasses.dataclass(frozen=True)
class ValidRegion:
    """Trim window inside a tile plus its destination in the output volume."""

    src: tuple[slice, slice, slice]  # slices into the tile's (F, H, W)
    dst: tuple[slice, slice, slice]  # slices into the full output (F, H, W)


def temporal_chunks(num_frames: int, chunk_len: int, overlap_t: int = 8) -> list[tuple[int, int]]:
    """Split F frames into overlapping [start, end) chunks.

    chunk_len == 0 disables chunking. A too-short tail chunk is merged into the
    previous one, so the final chunk may be longer than chunk_len.
    """
    if chunk_len == 0:
        return [(0, num_frames)]
    stride = chunk_len - overlap_t
    if stride <= 0:
        raise ValueError("chunk_len must be greater than overlap_t")
    # or [0]: a clip no longer than the overlap is one (short) chunk
    starts = list(range(0, num_frames - overlap_t, stride)) or [0]
    chunks = [(s, min(s + chunk_len, num_frames)) for s in starts]
    if len(chunks) >= 2 and chunks[-1][1] - chunks[-1][0] < chunk_len:
        tail = chunks.pop()
        chunks[-1] = (chunks[-1][0], tail[1])
    return chunks


def valid_region(
    tile: Tile,
    full_shape: tuple[int, int, int],
    overlap_t: int,
    overlap_hw: tuple[int, int],
) -> ValidRegion:
    """Interior of a tile that is written to the output (half-overlap trim).

    Tiles touching a border keep their full extent on that side; interior edges
    give up half the overlap so neighbouring tiles meet without double-writing
    (the leading edge ceil(ov/2), the trailing edge floor(ov/2)).
    """
    F, H, W = full_shape
    oh, ow = overlap_hw

    def _axis(start: int, end: int, size: int, ov: int) -> tuple[slice, slice]:
        length = end - start
        v0 = 0 if start == 0 else ov - ov // 2
        v1 = length if end == size else length - ov // 2
        return slice(v0, v1), slice(start + v0, start + v1)

    st, dt = _axis(tile.t_start, tile.t_end, F, overlap_t)
    sh, dh = _axis(tile.h_start, tile.h_end, H, oh)
    sw, dw = _axis(tile.w_start, tile.w_end, W, ow)
    return ValidRegion(src=(st, sh, sw), dst=(dt, dh, dw))


def next_valid_frames(n: int, temporal_ratio: int = 4) -> int:
    """Smallest m >= n whose causal-VAE encode/decode roundtrip preserves the
    frame count (m % (2*ratio) in {0, 1}, or m == 1)."""
    if n <= 1:
        return 1
    period = 2 * temporal_ratio
    if n % period in (0, 1):
        return n
    up0 = ((n + period - 1) // period) * period  # next multiple of 2r
    up1 = ((n - 1 + period - 1) // period) * period + 1  # next == 1 (mod 2r)
    return min(u for u in (up0, up1) if u >= n)


def compute_padding(num_frames: int, height: int, width: int) -> tuple[int, int, int]:
    """(pad_f, pad_h, pad_w) so that (F-1)%8==0 and H,W are multiples of 16
    (the 4x-temporal VAE with patch_size_t=2, and the 8x spatial VAE times
    patch_size=2)."""
    rem = (num_frames - 1) % 8
    pad_f = 0 if rem == 0 else 8 - rem
    pad_h = (16 - height % 16) % 16
    pad_w = (16 - width % 16) % 16
    return pad_f, pad_h, pad_w


def pad_video(frames: np.ndarray) -> tuple[np.ndarray, tuple[int, int, int]]:
    """Pad [F, H, W, C] frames: repeat last frame in time, zero-pad bottom/right."""
    F, H, W, _ = frames.shape
    pad_f, pad_h, pad_w = compute_padding(F, H, W)
    if pad_f:
        frames = np.concatenate([frames, np.repeat(frames[-1:], pad_f, axis=0)], axis=0)
    if pad_h or pad_w:
        frames = np.pad(frames, ((0, 0), (0, pad_h), (0, pad_w), (0, 0)))
    return frames, (pad_f, pad_h, pad_w)


def i420_crop(clip: np.ndarray, new_h: int, new_w: int) -> np.ndarray:
    """Top-left crop of packed planar I420 frames [F, H*3//2, W] to
    (new_h, new_w); both must be even (4:2:0 chroma is 2x2-subsampled)."""
    F, Hp, W = clip.shape
    H = Hp * 2 // 3
    if new_h == H and new_w == W:
        return clip
    if new_h % 2 or new_w % 2:
        raise ValueError(f"I420 crop must be even, got {new_h}x{new_w}")
    y = clip[:, :H, :new_w][:, :new_h]
    u = clip[:, H : H + H // 4].reshape(F, H // 2, W // 2)
    v = clip[:, H + H // 4 :].reshape(F, H // 2, W // 2)
    u = u[:, : new_h // 2, : new_w // 2]
    v = v[:, : new_h // 2, : new_w // 2]
    flat = np.concatenate(
        [y.reshape(F, -1), u.reshape(F, -1), v.reshape(F, -1)], axis=1
    )
    return flat.reshape(F, new_h * 3 // 2, new_w)


def unpad_video(video: np.ndarray, pad_f: int, pad_h: int, pad_w: int) -> np.ndarray:
    """Crop [C, F, H, W] output; spatial pads are given in *output* pixels."""
    if pad_f:
        video = video[:, :-pad_f]
    if pad_h:
        video = video[:, :, :-pad_h]
    if pad_w:
        video = video[:, :, :, :-pad_w]
    return video
