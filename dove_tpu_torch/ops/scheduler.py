"""Diffusion schedule algebra for one-step DOVE (PyTorch).

Counterpart of ``dove_tpu/ops/scheduler.py``. DOVE uses two pieces of the
CogVideoX scheduler:

  * ``add_noise(x, eps, t)   = sqrt(abar_t) * x + sqrt(1-abar_t) * eps``
  * ``get_velocity(v, z, t)  = sqrt(abar_t) * z - sqrt(1-abar_t) * v``
    (called with (pred_velocity, noisy_latent) the result IS x-hat_0)

Wan2.1 is a flow-matching model: z_t = (1 - sigma) x_0 + sigma eps and the
DiT predicts u = eps - x_0, so one step from z at sigma = t / T (shift 1)
gives x-hat_0 = z - sigma u (:func:`flow_x0`).

The alpha-bar table is CogVideoX's: scaled-linear betas -> cumprod -> SNR
shift -> zero-terminal-SNR rescale, built in float64 with NumPy and kept as
an fp32 tensor.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from dove_tpu_torch.config import SchedulerConfig


def _make_betas(cfg: SchedulerConfig) -> np.ndarray:
    n = cfg.num_train_timesteps
    if cfg.beta_schedule == "scaled_linear":
        return (
            np.linspace(cfg.beta_start**0.5, cfg.beta_end**0.5, n, dtype=np.float64)
            ** 2
        )
    if cfg.beta_schedule == "linear":
        return np.linspace(cfg.beta_start, cfg.beta_end, n, dtype=np.float64)
    raise ValueError(f"Unsupported beta_schedule: {cfg.beta_schedule}")


def _rescale_zero_terminal_snr(alphas_cumprod: np.ndarray) -> np.ndarray:
    """Shift+scale sqrt(abar) so the final timestep has exactly zero SNR
    (Lin et al., "Common Diffusion Noise Schedules and Sample Steps are
    Flawed"), applied to alpha-bar directly as CogVideoX does."""
    abar_sqrt = np.sqrt(alphas_cumprod)
    a0, aT = abar_sqrt[0], abar_sqrt[-1]
    abar_sqrt = (abar_sqrt - aT) * (a0 / (a0 - aT))
    return abar_sqrt**2


def make_alphas_cumprod(cfg: SchedulerConfig) -> np.ndarray:
    """Full alpha-bar table, shape (num_train_timesteps,), float64."""
    betas = _make_betas(cfg)
    alphas_cumprod = np.cumprod(1.0 - betas)
    # SNR shift (CogVideoX): abar <- abar / (s + (1-s)*abar)
    s = cfg.snr_shift_scale
    alphas_cumprod = alphas_cumprod / (s + (1.0 - s) * alphas_cumprod)
    if cfg.rescale_betas_zero_snr:
        alphas_cumprod = _rescale_zero_terminal_snr(alphas_cumprod)
    return alphas_cumprod


@dataclasses.dataclass(frozen=True)
class Schedule:
    """Precomputed fp32 alpha-bar table with the two DOVE operations."""

    alphas_cumprod: torch.Tensor  # (T,), float32, on the CPU

    @classmethod
    def create(cls, cfg: SchedulerConfig | None = None) -> "Schedule":
        cfg = cfg or SchedulerConfig()
        return cls(torch.as_tensor(make_alphas_cumprod(cfg), dtype=torch.float32))

    def _coeffs(
        self, t: torch.Tensor | int, ref: torch.Tensor
    ) -> tuple[torch.Tensor, torch.Tensor]:
        t = torch.atleast_1d(torch.as_tensor(t, dtype=torch.long))
        abar = self.alphas_cumprod[t.cpu()]
        sqrt_abar = torch.sqrt(abar).to(device=ref.device, dtype=ref.dtype)
        sqrt_1m = torch.sqrt(1.0 - abar).to(device=ref.device, dtype=ref.dtype)
        shape = (-1,) + (1,) * (ref.ndim - 1)
        return sqrt_abar.reshape(shape), sqrt_1m.reshape(shape)

    def add_noise(
        self, sample: torch.Tensor, noise: torch.Tensor, t: torch.Tensor | int
    ) -> torch.Tensor:
        """z_t = sqrt(abar_t) x_0 + sqrt(1-abar_t) eps.  t: int tensor (B,) or scalar."""
        a, b = self._coeffs(t, sample)
        return a * sample + b * noise

    def get_velocity(
        self, sample: torch.Tensor, noise: torch.Tensor, t: torch.Tensor | int
    ) -> torch.Tensor:
        """v = sqrt(abar_t) * noise - sqrt(1-abar_t) * sample.

        DOVE's one-step trick calls this as get_velocity(v_pred, z_t, t), which
        evaluates to sqrt(abar_t) z_t - sqrt(1-abar_t) v_pred = x-hat_0."""
        a, b = self._coeffs(t, sample)
        return a * noise - b * sample

    def velocity_to_x0(
        self, v_pred: torch.Tensor, z_t: torch.Tensor, t: torch.Tensor | int
    ) -> torch.Tensor:
        """Explicitly-named alias for the one-step denoise formula."""
        return self.get_velocity(v_pred, z_t, t)


def flow_x0(z: torch.Tensor, u: torch.Tensor, sigma: float) -> torch.Tensor:
    """x-hat_0 = z - sigma * u in fp32 (a flow model's one step to t = 0)."""
    return z.float() - sigma * u.float()
