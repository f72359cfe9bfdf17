"""The one-step denoise core shared by inference and the DOVE training losses.

Counterpart of ``one_step_x0_latent`` in ``dove_tpu/train/losses.py``. The
stage-1 and stage-2 losses come with the training slice of the port.
"""

from __future__ import annotations

import torch

from dove_tpu_torch.config import PipelineConfig
from dove_tpu_torch.models.dit import CogVideoXTransformer3D
from dove_tpu_torch.ops.scheduler import Schedule


def one_step_x0_latent(
    cfg: PipelineConfig,
    schedule: Schedule,
    dit: CogVideoXTransformer3D,
    lq_latent: torch.Tensor,  # [B, F', h, w, C] scaled latent
    text_embeds: torch.Tensor,  # [B, L, text_dim]
    noise: torch.Tensor | None = None,
    attention_backend: str | None = None,
    bounded_logits: bool = False,
) -> torch.Tensor:
    """x-hat_0 in [B, F', h, w, C] from one DiT pass at ``cfg.sr_noise_step``.

    The latent is front-padded with copies of its first frame to a multiple
    of patch_size_t and the padding is stripped again. When
    ``cfg.noise_step != 0`` and ``noise`` ([B, F'+pad, C, h, w], the DiT
    layout) is given, it is added at that timestep first; the caller draws
    it, so that tests can hand both packages the same numbers."""
    B = lq_latent.shape[0]
    pt = cfg.dit.patch_size_t
    # (pt - F % pt) % pt: the reference's F % pt at pt=2, right for any pt
    ncopy = (pt - lq_latent.shape[1] % pt) % pt
    if ncopy:
        first = lq_latent[:, :1].expand(-1, ncopy, -1, -1, -1)
        lq_latent = torch.cat([first, lq_latent], dim=1)

    z = lq_latent.permute(0, 1, 4, 2, 3)  # -> [B, F, C, h, w]
    if cfg.noise_step != 0 and noise is not None:
        t_add = torch.full((B,), cfg.noise_step, dtype=torch.long)
        z = schedule.add_noise(z, noise.to(z.dtype), t_add)

    t_sr = torch.full((B,), cfg.sr_noise_step, dtype=torch.long, device=z.device)
    v_pred = dit(
        z, text_embeds, t_sr,
        attention_backend=attention_backend, bounded_logits=bounded_logits,
    )
    x0 = schedule.velocity_to_x0(v_pred, z, t_sr)
    if ncopy:
        x0 = x0[:, ncopy:]
    return x0.permute(0, 1, 3, 4, 2)  # -> [B, F', h, w, C]
