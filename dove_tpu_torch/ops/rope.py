"""3D rotary positional embeddings for the CogVideoX DiT (PyTorch).

Counterpart of ``dove_tpu/ops/rope.py``: diffusers'
``get_3d_rotary_pos_embed(..., grid_type="slice")``. The head dim D splits
into (D/4 temporal, 3D/8 height, 3D/8 width) bands, each a 1D rotary table
over integer grid positions, broadcast over the (T, H, W) token grid and
flattened T-major, then H, then W (the DiT's patchify token order).
Frequencies repeat in interleaved pairs (cos0, cos0, cos1, cos1, ...) and the
rotation acts on interleaved (even, odd) lanes.

Wan2.1's table (``wan/modules/model.py`` ``rope_params`` / ``rope_apply``)
takes the same interleaved rotation with other bands: of D/2 complex pairs,
D/2 - 2 (D/12) turn with the frame and D/12 each with the row and the column
(22 / 21 / 21 at D = 128), each band at 10000^(-2j / band width) over raw
grid positions from 0.
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
def _rope_bands_np(
    dims: tuple[int, int, int], num_frames: int, grid_h: int, grid_w: int, theta: float,
) -> tuple[np.ndarray, np.ndarray]:
    """(cos, sin), each (T*H*W, sum(dims)): the frame, row and column bands'
    1D tables broadcast over the grid, T-major."""
    tabs = [_rope_1d(d, n, theta) for d, n in zip(dims, (num_frames, grid_h, grid_w))]
    shape = (num_frames, grid_h, grid_w)

    def combine(i: int) -> np.ndarray:
        t, h, w = (tab[i] for tab in tabs)
        return np.concatenate([
            np.broadcast_to(t[:, None, None, :], shape + (dims[0],)),
            np.broadcast_to(h[None, :, None, :], shape + (dims[1],)),
            np.broadcast_to(w[None, None, :, :], shape + (dims[2],)),
        ], axis=-1).reshape(-1, sum(dims))

    return combine(0), combine(1)


def _rope_3d_np(
    head_dim: int, num_frames: int, grid_h: int, grid_w: int, theta: float,
) -> tuple[np.ndarray, np.ndarray]:
    dims = (head_dim // 4, head_dim // 8 * 3, head_dim // 8 * 3)
    if sum(dims) != head_dim:
        raise ValueError(f"head_dim must be divisible by 8, got {head_dim}")
    return _rope_bands_np(dims, num_frames, grid_h, grid_w, theta)


def wan_rope_3d(
    head_dim: int, num_frames: int, grid_h: int, grid_w: int, theta: float = 10000.0,
    device: torch.device | str = "cpu",
) -> tuple[torch.Tensor, torch.Tensor]:
    """Wan2.1's fp32 (cos, sin) tables (F*H*W, head_dim) for
    :func:`apply_rotary`: the angles in float64, as Wan computes them."""
    d6 = head_dim // 6
    cos, sin = _rope_bands_np((head_dim - 4 * d6, 2 * d6, 2 * d6), num_frames, grid_h,
                              grid_w, theta)
    return torch.tensor(cos, device=device), torch.tensor(sin, device=device)


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
