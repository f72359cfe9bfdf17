"""Fixed 3D sin-cos positional embeddings (CogVideoX-2B / DOVE-2B path).

A copy of ``dove_tpu/ops/sincos.py`` (NumPy only; the port imports nothing
of the JAX package).

Mirrors diffusers' ``get_3d_sincos_pos_embed`` layout: head dim splits into
1/4 temporal + 3/4 spatial; spatial half further splits evenly between the two
meshgrid axes; each band is [sin | cos] of pos x omega. Used only when
``use_rotary_positional_embeddings`` is False (the 2B family).
"""

from __future__ import annotations

import numpy as np


def _sincos_1d(dim: int, pos: np.ndarray) -> np.ndarray:
    """pos (M,) -> (M, dim): concat[sin, cos] over dim/2 frequencies."""
    omega = 1.0 / (10000.0 ** (np.arange(dim // 2, dtype=np.float64) / (dim / 2.0)))
    out = np.outer(pos.reshape(-1), omega)
    return np.concatenate([np.sin(out), np.cos(out)], axis=-1)


def get_3d_sincos_pos_embed(
    embed_dim: int,
    width: int,
    height: int,
    temporal_size: int,
    spatial_interpolation_scale: float = 1.875,
    temporal_interpolation_scale: float = 1.0,
) -> np.ndarray:
    """Returns (T, H*W, embed_dim) float64 table; caller flattens/casts."""
    dim_spatial = 3 * embed_dim // 4
    dim_temporal = embed_dim // 4

    grid_h = np.arange(height, dtype=np.float64) / spatial_interpolation_scale
    grid_w = np.arange(width, dtype=np.float64) / spatial_interpolation_scale
    gw, gh = np.meshgrid(grid_w, grid_h)  # each (H, W)
    emb_w = _sincos_1d(dim_spatial // 2, gw)
    emb_h = _sincos_1d(dim_spatial // 2, gh)
    spatial = np.concatenate([emb_w, emb_h], axis=-1)  # (H*W, dim_spatial)

    grid_t = np.arange(temporal_size, dtype=np.float64) / temporal_interpolation_scale
    temporal = _sincos_1d(dim_temporal, grid_t)  # (T, dim_temporal)

    spatial = np.repeat(spatial[None], temporal_size, axis=0)  # (T, HW, Ds)
    temporal = np.repeat(temporal[:, None], height * width, axis=1)  # (T, HW, Dt)
    return np.concatenate([temporal, spatial], axis=-1)
