"""The one-step denoise core shared by inference and the DOVE training losses.

Counterpart of ``dove_tpu/train/losses.py``. Stage 1 is the latent MSE
between the one-step x-hat_0 and the HQ latent (reference:
lora_one_s1_trainer.py:116-209). Stage 2 decodes x-hat_0 frame by frame WITH
gradients and combines the pixel MSE, a perceptual term (DISTS or LPIPS,
optionally edge-weighted) and the temporal frame-difference L1 (reference:
lora_one_s2_trainer.py:124-297).
"""

from __future__ import annotations

from typing import Any, Callable

import torch
import torch.nn.functional as F

from dove_tpu_torch import obs
from dove_tpu_torch.config import PipelineConfig
from dove_tpu_torch.models import vae as vae_mod
from dove_tpu_torch.models.dit import CogVideoXTransformer3D, temporal_pad
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
    lora: Any = None,
    lora_scale: float = 1.0,
    gradient_checkpointing: bool = False,
    sp: Any = None,
) -> torch.Tensor:
    """x-hat_0 in [B, F', h, w, C] from one DiT pass at ``cfg.sr_noise_step``.

    The latent is front-padded with copies of its first frame to a multiple
    of patch_size_t and the padding is stripped again. When
    ``cfg.noise_step != 0`` and ``noise`` ([B, F'+pad, C, h, w], the DiT
    layout) is given, it is added at that timestep first; the caller draws
    it, so that tests can hand both packages the same numbers. lora,
    lora_scale, gradient_checkpointing and sp (sequence parallelism) go to
    the DiT's forward."""
    B = lq_latent.shape[0]
    # (pt - F % pt) % pt: the reference's F % pt at pt=2, right for any pt;
    # none without temporal patching (the 2B)
    ncopy = temporal_pad(cfg.dit, lq_latent.shape[1])
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
        lora=lora, lora_scale=lora_scale,
        gradient_checkpointing=gradient_checkpointing, sp=sp,
    )
    x0 = schedule.velocity_to_x0(v_pred, z, t_sr)
    if ncopy:
        x0 = x0[:, ncopy:]
    return x0.permute(0, 1, 3, 4, 2)  # -> [B, F', h, w, C]


def stage1_loss(
    cfg: PipelineConfig,
    schedule: Schedule,
    dit: CogVideoXTransformer3D,
    batch: dict[str, torch.Tensor],
    noise: torch.Tensor | None = None,
    **fwd_kwargs,
) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
    """Latent-space MSE -> (loss, {"loss_mse": loss}). batch: lq_latent and
    hq_latent [B, F', h, w, C] (VAE-encoded and scaled), prompt_embeds
    [B, L, text_dim]; fwd_kwargs go to :func:`one_step_x0_latent`."""
    x0 = one_step_x0_latent(
        cfg, schedule, dit, batch["lq_latent"], batch["prompt_embeds"], noise,
        **fwd_kwargs,
    )
    loss = torch.mean((x0.float() - batch["hq_latent"].float()) ** 2)
    return loss, {"loss_mse": loss}


def frame_difference_l1(video: torch.Tensor) -> torch.Tensor:
    """Temporal difference map, [B, F-1, H, W, C]."""
    return video[:, 1:] - video[:, :-1]


def sobel_edges(frames: torch.Tensor) -> torch.Tensor:
    """Sobel gradient magnitude per channel (the reference's
    EdgeDetectionModel, finetune/utils/metric_utils.py:210-241). frames:
    [B, H, W, C] -> [B, H, W, C] fp32. The JAX package convolves with a dense
    C -> C kernel that is the identity over channels; this depthwise conv
    has the same nonzero terms."""
    kx = torch.tensor([[-1, 0, 1], [-2, 0, 2], [-1, 0, 1]], dtype=torch.float32,
                      device=frames.device)
    C = frames.shape[-1]
    x = frames.float().permute(0, 3, 1, 2)
    gx = F.conv2d(x, kx.expand(C, 1, 3, 3), padding=1, groups=C)
    gy = F.conv2d(x, kx.T.expand(C, 1, 3, 3), padding=1, groups=C)
    return torch.sqrt(gx * gx + gy * gy + 1e-12).permute(0, 2, 3, 1)


def make_perceptual_fn(
    kind: str = "dists",
    edge_aware: bool = False,
    weights_path: str | None = None,
    device="cpu",
) -> Callable[[torch.Tensor, torch.Tensor], torch.Tensor]:
    """The stage-2 per-frame perceptual loss (reference
    lora_one_s2_trainer.py:240-277): DISTS or LPIPS averaged over frames,
    optionally averaged with the same distance on Sobel edge maps (the
    "ea_" weights).

    Without a weight file, a seeded random VGG16 with uniform heads
    (``eval.vgg.init_vgg16``; its draws differ from the JAX package's): the
    trainer takes this only when the caller opts in. The VGG runs in fp32
    on ``device``."""
    from dove_tpu_torch.eval import vgg as vgg_mod

    if weights_path:
        sd = vgg_mod._read_state_dict(weights_path)
        vgg = vgg_mod.vgg16_from_torch_sd(sd, device)
    else:
        vgg = vgg_mod.init_vgg16(0, device)
    if kind == "dists":
        if weights_path and "alpha" in sd:
            alpha, beta = vgg_mod.dists_heads(sd, device)
        else:
            alpha, beta = vgg_mod.init_dists_weights(device=device)

        def frame_d(x, y):  # [N, H, W, 3] in [0, 1]
            return vgg_mod.dists_distance(vgg, alpha, beta, x, y).mean()
    elif kind == "lpips":
        lins = [torch.ones((c,), dtype=torch.float32, device=device)
                for c, _ in vgg_mod.VGG16_STAGES]
        if weights_path:  # the "lins." names only, as the JAX package reads them
            heads = [vgg_mod.lpips_head(sd, k, vgg_mod.LPIPS_HEAD_KEYS[:1], device)
                     for k in range(5)]
            lins = [w if h is None else h for h, w in zip(heads, lins)]

        def frame_d(x, y):  # lpips wants [-1, 1]
            return vgg_mod.lpips_distance(vgg, lins, x * 2 - 1, y * 2 - 1).mean()
    else:
        raise ValueError(f"unknown perceptual kind: {kind}")

    def perceptual(pred: torch.Tensor, hq: torch.Tensor) -> torch.Tensor:
        """pred, hq: [B, F, H, W, 3] fp32 in [0, 1] -> scalar."""
        x = pred.reshape((-1,) + pred.shape[2:])
        y = hq.reshape((-1,) + hq.shape[2:])
        loss = frame_d(x, y)
        if edge_aware:
            loss = (loss + frame_d(sobel_edges(x), sobel_edges(y))) * 0.5
        return loss

    return perceptual


def stage2_loss(
    cfg: PipelineConfig,
    schedule: Schedule,
    dit: CogVideoXTransformer3D,
    vae: vae_mod.AutoencoderKLCogVideoX,
    batch: dict[str, torch.Tensor],
    noise: torch.Tensor | None = None,
    *,
    pixel_weight: float = 1.0,
    perceptual_weight: float = 1.0,
    frame_diff_weight: float = 1.0,
    perceptual_fn: Callable[[torch.Tensor, torch.Tensor], torch.Tensor] | None = None,
    **fwd_kwargs,
) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
    """Pixel-space composite loss -> (loss, aux). batch: lq_latent [B, F', h,
    w, C] (scaled), hq_video [B, F, H, W, 3] in [-1, 1] with F == F' (every
    frame encoded as a clip of its own), prompt_embeds. fwd_kwargs go to
    :func:`one_step_x0_latent`; its ``gradient_checkpointing`` also
    checkpoints the decoder a level at a time, as the JAX package's
    ``remat`` does both.

    Every frame decodes as an independent 1-frame video WITH gradients
    (reference lora_one_s2_trainer.py:228-233), so pixel and latent frame
    counts match and the decode's memory stays bounded. All terms are taken
    in [0, 1] after a clamp of both sides (lora_one_s2_trainer.py:147,
    228-235); the frame-difference term only when F > 1."""
    with obs.span("train.dit_fwd"):
        x0 = one_step_x0_latent(cfg, schedule, dit, batch["lq_latent"],
                                batch["prompt_embeds"], noise, **fwd_kwargs)
    z = x0 / torch.tensor(cfg.vae.scaling_factor, dtype=x0.dtype)
    B, Fl = z.shape[:2]
    z_frames = z.reshape((B * Fl, 1) + z.shape[2:])
    vae_dtype = vae.decoder.conv_in.conv.weight.dtype
    with obs.span("train.decode"):
        pred = vae_mod.decode(cfg.vae, vae, z_frames.to(vae_dtype),
                              remat=bool(fwd_kwargs.get("gradient_checkpointing")))
    pred = pred.reshape((B, Fl) + pred.shape[2:])  # [B, F, H, W, 3] in [-1, 1]
    hq = batch["hq_video"].to(pred.dtype)

    pf = torch.clamp(pred.float() * 0.5 + 0.5, 0.0, 1.0)
    hf = torch.clamp(hq.float() * 0.5 + 0.5, 0.0, 1.0)

    loss_pixel = torch.mean((pf - hf) ** 2)
    aux = {"loss_pixel": loss_pixel}
    total = pixel_weight * loss_pixel

    if perceptual_fn is not None and perceptual_weight > 0:
        with obs.span("train.perceptual"):
            loss_perc = perceptual_fn(pf, hf)
        aux["loss_perceptual"] = loss_perc
        total = total + perceptual_weight * loss_perc

    if frame_diff_weight > 0 and pred.shape[1] > 1:
        loss_fd = torch.mean(
            torch.abs(frame_difference_l1(pf) - frame_difference_l1(hf)))
        aux["loss_frame_diff"] = loss_fd
        total = total + frame_diff_weight * loss_fd

    aux["loss"] = total
    return total, aux
