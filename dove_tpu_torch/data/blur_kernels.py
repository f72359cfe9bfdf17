"""Random blur-kernel bank for Real-ESRGAN-style degradation synthesis.

Implements the standard second-order degradation kernel family (isotropic /
anisotropic Gaussian, generalized Gaussian, plateau, circular sinc low-pass)
from their published definitions; capability map of the reference's
finetune/datasets/blur_kernels.py (SURVEY.md §2.4). A copy of
``dove_tpu/data/blur_kernels.py``: host-side NumPy that feeds the input
pipeline, so that both packages draw the same kernels from the same
generator.
"""

from __future__ import annotations

import numpy as np
from scipy import special


def _mesh_grid(size: int) -> np.ndarray:
    """(size, size, 2) coordinate grid centered at 0."""
    ax = np.arange(size, dtype=np.float64) - (size - 1) / 2.0
    xx, yy = np.meshgrid(ax, ax)
    return np.stack([xx, yy], axis=-1)


def _sigma_matrix(sig_x: float, sig_y: float, theta: float) -> np.ndarray:
    d = np.array([[sig_x**2, 0.0], [0.0, sig_y**2]])
    u = np.array(
        [[np.cos(theta), -np.sin(theta)], [np.sin(theta), np.cos(theta)]]
    )
    return u @ d @ u.T


def _quadratic_form(grid: np.ndarray, sigma: np.ndarray) -> np.ndarray:
    inv = np.linalg.inv(sigma)
    return np.einsum("hwi,ij,hwj->hw", grid, inv, grid)


def bivariate_gaussian(
    size: int, sig_x: float, sig_y: float | None = None, theta: float = 0.0,
    isotropic: bool = True,
) -> np.ndarray:
    sig_y = sig_x if isotropic else sig_y
    grid = _mesh_grid(size)
    q = _quadratic_form(grid, _sigma_matrix(sig_x, sig_y, 0.0 if isotropic else theta))
    k = np.exp(-0.5 * q)
    return k / k.sum()


def bivariate_generalized_gaussian(
    size: int, sig_x: float, sig_y: float | None, theta: float, beta: float,
    isotropic: bool = True,
) -> np.ndarray:
    sig_y = sig_x if isotropic else sig_y
    grid = _mesh_grid(size)
    q = _quadratic_form(grid, _sigma_matrix(sig_x, sig_y, 0.0 if isotropic else theta))
    k = np.exp(-0.5 * np.power(q, beta))
    return k / k.sum()


def bivariate_plateau(
    size: int, sig_x: float, sig_y: float | None, theta: float, beta: float,
    isotropic: bool = True,
) -> np.ndarray:
    sig_y = sig_x if isotropic else sig_y
    grid = _mesh_grid(size)
    q = _quadratic_form(grid, _sigma_matrix(sig_x, sig_y, 0.0 if isotropic else theta))
    k = 1.0 / (np.power(q, beta) + 1.0)
    return k / k.sum()


def circular_lowpass_kernel(omega: float, size: int, pad_to: int = 0) -> np.ndarray:
    """2D sinc (circular low-pass) filter with cutoff omega; size must be odd."""
    assert size % 2 == 1
    with np.errstate(divide="ignore", invalid="ignore"):
        ax = np.arange(size) - (size - 1) / 2
        xx, yy = np.meshgrid(ax, ax)
        r = np.sqrt(xx**2 + yy**2)
        k = omega * special.j1(omega * r) / (2 * np.pi * r)
        k[(size - 1) // 2, (size - 1) // 2] = omega**2 / (4 * np.pi)
    k = k * np.outer(np.hamming(size), np.hamming(size))
    k = k / k.sum()
    if pad_to > size:
        pad = (pad_to - size) // 2
        k = np.pad(k, ((pad, pad), (pad, pad)))
    return k


KERNEL_TYPES = (
    "iso", "aniso", "generalized_iso", "generalized_aniso",
    "plateau_iso", "plateau_aniso", "sinc",
)


def random_mixed_kernel(
    rng: np.random.Generator,
    kernel_list: list[str],
    kernel_prob: list[float],
    kernel_size: int,
    sigma_x_range: tuple[float, float] = (0.6, 5.0),
    sigma_y_range: tuple[float, float] = (0.6, 5.0),
    rotation_range: tuple[float, float] = (-np.pi, np.pi),
    betag_range: tuple[float, float] = (0.5, 8.0),
    betap_range: tuple[float, float] = (0.5, 8.0),
    omega_range: tuple[float, float] = (np.pi / 3, np.pi),
) -> np.ndarray:
    """Sample one kernel of a random type (weights kernel_prob)."""
    ktype = rng.choice(kernel_list, p=np.asarray(kernel_prob) / np.sum(kernel_prob))
    sx = rng.uniform(*sigma_x_range)
    sy = rng.uniform(*sigma_y_range)
    th = rng.uniform(*rotation_range)
    if ktype == "iso":
        return bivariate_gaussian(kernel_size, sx, isotropic=True)
    if ktype == "aniso":
        return bivariate_gaussian(kernel_size, sx, sy, th, isotropic=False)
    if ktype == "generalized_iso":
        b = rng.uniform(*betag_range)
        return bivariate_generalized_gaussian(kernel_size, sx, None, 0.0, b, True)
    if ktype == "generalized_aniso":
        b = rng.uniform(*betag_range)
        return bivariate_generalized_gaussian(kernel_size, sx, sy, th, b, False)
    if ktype == "plateau_iso":
        b = rng.uniform(*betap_range)
        return bivariate_plateau(kernel_size, sx, None, 0.0, b, True)
    if ktype == "plateau_aniso":
        b = rng.uniform(*betap_range)
        return bivariate_plateau(kernel_size, sx, sy, th, b, False)
    if ktype == "sinc":
        omega = rng.uniform(*omega_range)
        return circular_lowpass_kernel(omega, kernel_size)
    raise ValueError(f"unknown kernel type {ktype}")
