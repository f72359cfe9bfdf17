"""3D rotary positional embeddings for the CogVideoX DiT (PyTorch).

Counterpart of ``dove_tpu/ops/rope.py``: diffusers'
``get_3d_rotary_pos_embed(..., grid_type="slice")``. The head dim D splits
into (D/4 temporal, 3D/8 height, 3D/8 width) bands, each a 1D rotary table
over integer grid positions, broadcast over the (T, H, W) token grid and
flattened T-major, then H, then W (the DiT's patchify token order).
Frequencies repeat in interleaved pairs (cos0, cos0, cos1, cos1, ...) and the
rotation acts on interleaved (even, odd) lanes.
"""

from __future__ import annotations

import functools

import numpy as np
import torch


@functools.lru_cache(maxsize=64)
def _rope_1d(dim: int, length: int, theta: float) -> tuple[np.ndarray, np.ndarray]:
    """1D rotary tables (cos, sin), each (length, dim), pairs interleaved."""
    freqs = 1.0 / (theta ** (np.arange(0, dim, 2, dtype=np.float64) / dim))
    angles = np.outer(np.arange(length, dtype=np.float64), freqs)  # (L, dim/2)
    cos = np.repeat(np.cos(angles), 2, axis=1).astype(np.float32)
    sin = np.repeat(np.sin(angles), 2, axis=1).astype(np.float32)
    return cos, sin


@functools.lru_cache(maxsize=64)
def _rope_3d_np(
    head_dim: int, num_frames: int, grid_h: int, grid_w: int, theta: float,
) -> tuple[np.ndarray, np.ndarray]:
    dim_t = head_dim // 4
    dim_h = head_dim // 8 * 3
    dim_w = head_dim // 8 * 3
    if dim_t + dim_h + dim_w != head_dim:
        raise ValueError(f"head_dim must be divisible by 8, got {head_dim}")

    cos_t, sin_t = _rope_1d(dim_t, num_frames, theta)
    cos_h, sin_h = _rope_1d(dim_h, grid_h, theta)
    cos_w, sin_w = _rope_1d(dim_w, grid_w, theta)

    def combine(t: np.ndarray, h: np.ndarray, w: np.ndarray) -> np.ndarray:
        shape = (num_frames, grid_h, grid_w)
        t3 = np.broadcast_to(t[:, None, None, :], shape + (dim_t,))
        h3 = np.broadcast_to(h[None, :, None, :], shape + (dim_h,))
        w3 = np.broadcast_to(w[None, None, :, :], shape + (dim_w,))
        return np.concatenate([t3, h3, w3], axis=-1).reshape(-1, head_dim)

    return combine(cos_t, cos_h, cos_w), combine(sin_t, sin_h, sin_w)


def rope_3d(
    head_dim: int,
    num_frames: int,
    grid_h: int,
    grid_w: int,
    theta: float = 10000.0,
    device: torch.device | str = "cpu",
) -> tuple[torch.Tensor, torch.Tensor]:
    """fp32 (cos, sin) tables of shape (T*H*W, head_dim) for the video grid.

    ``num_frames`` counts temporal patches (latent frames / patch_size_t);
    grid_h/grid_w are latent H/W divided by patch_size."""
    cos, sin = _rope_3d_np(head_dim, num_frames, grid_h, grid_w, theta)
    # copies: the NumPy tables are cached and must not alias a caller's tensor
    return torch.tensor(cos, device=device), torch.tensor(sin, device=device)


def apply_rotary(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """Rotate interleaved (even, odd) pairs: out = x*cos + rot(x)*sin.

    x: [..., S, D]; cos/sin: [S, D]. Computed in fp32, cast back to x.dtype."""
    xf = x.float()
    x2 = xf.unflatten(-1, (-1, 2))
    rotated = torch.stack([-x2[..., 1], x2[..., 0]], dim=-1).flatten(-2)
    return (xf * cos + rotated * sin).to(x.dtype)
