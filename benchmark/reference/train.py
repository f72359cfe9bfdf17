"""The stage-1 LoRA step (``train_s1.sh``), in float32: the reference follows
the program's first steps from the same weights, LoRA factors and batches.

Each step works out again: the VAE encode of the LQ and HQ clips, their
posterior samples from generators seeded from (seed, step, stream) as the
trainer seeds them, the one-step x0 of the DiT with the LoRA added to its q,
k, v and out projections, the latent MSE, its gradients with respect to the
LoRA factors, the clip by global norm and the AdamW update under the
warm-up schedule. Returns what the optimizer saw and did: the loss of each
step, the norm of each leaf's first (clipped) gradient, and the norm of each
leaf's change after the last step.
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark.reference.models import DiT, VAE, alphas_cumprod, one_step_x0


def step_seed(seed: int, step: int, stream: int) -> int:
    """The trainer's per-step stream seed: SeedSequence([seed, step, stream])."""
    return int(np.random.SeedSequence([seed, step, stream]).generate_state(1)[0])


def lr_at(count: int, lr: float, warmup: int) -> float:
    """constant_with_warmup: linear from 0 over ``warmup`` steps, then ``lr``."""
    return lr * min(count, warmup) / warmup if warmup > 0 else lr


def encode_sample(vae: VAE, video: torch.Tensor, seed: int, scale: float) -> torch.Tensor:
    """Pixels [B, F, H, W, 3] in [-1, 1] -> the scaled posterior sample
    [B, F', h, w, C]; one clip at a time, one draw for the whole batch."""
    moments = torch.cat([vae.encode(v[None].permute(0, 4, 1, 2, 3))
                         for v in video]).permute(0, 2, 3, 4, 1)
    mean, logvar = moments.chunk(2, dim=-1)
    gen = torch.Generator(device=video.device).manual_seed(seed)
    eps = torch.randn(mean.shape, generator=gen, device=video.device, dtype=torch.float32)
    return (mean + torch.exp(0.5 * logvar.clamp(-30.0, 20.0)) * eps) * scale


def lora_steps(dit_params, vae_params, cfg: dict, lora0: dict, batches, prompt,
               hp: dict, linear=None) -> dict:
    """Run ``len(batches)`` steps from ``lora0`` ({target: {"A", "B"}}, left
    untouched). ``hp``: seed, lr, warmup, beta1, beta2, eps, weight_decay,
    max_grad_norm, lora_scale. -> {"loss": [per step], "grad": {leaf: norm
    of the first clipped gradient}, "change": {leaf: norm of the change}}."""
    c_dit, c_vae = cfg["dit"], cfg["vae"]
    leaves = [(t, ab) for t in lora0 for ab in ("A", "B")]
    params = {t: {ab: lora0[t][ab].detach().clone().requires_grad_() for ab in ("A", "B")}
              for t in lora0}
    mu = {k: torch.zeros_like(params[k[0]][k[1]]) for k in leaves}
    nu = {k: torch.zeros_like(params[k[0]][k[1]]) for k in leaves}
    dit = DiT(dit_params, c_dit, linear, lora=params, lora_scale=hp["lora_scale"],
              remat=True)
    vae = VAE(vae_params, c_vae)
    abar = alphas_cumprod(cfg["scheduler"])
    b1, b2 = hp["beta1"], hp["beta2"]
    out = {"loss": [], "grad": {}, "change": {}}
    for step, batch in enumerate(batches):
        with torch.no_grad():
            lq = encode_sample(vae, batch["lq_video"], step_seed(hp["seed"], step, 0),
                               c_vae["scaling_factor"])
            hq = encode_sample(vae, batch["hq_video"], step_seed(hp["seed"], step, 1),
                               c_vae["scaling_factor"])
        text = prompt.float()[None].expand(lq.shape[0], -1, -1)
        x0 = one_step_x0(dit, c_dit, abar, lq, text, cfg["sr_noise_step"])
        loss = torch.mean((x0 - hq) ** 2)
        grads = torch.autograd.grad(loss, [params[t][ab] for t, ab in leaves])
        out["loss"].append(float(loss.detach()))
        with torch.no_grad():
            norm = torch.sqrt(sum(g.square().sum() for g in grads))
            if norm >= hp["max_grad_norm"]:
                grads = [g / norm * hp["max_grad_norm"] for g in grads]
            if step == 0:
                out["grad"] = {f"{t}.{ab}": float(g.norm()) for (t, ab), g in zip(leaves, grads)}
            lr = lr_at(step, hp["lr"], hp["warmup"])
            c1, c2 = 1 - b1 ** (step + 1), 1 - b2 ** (step + 1)
            for k, g in zip(leaves, grads):
                p = params[k[0]][k[1]]
                mu[k] = (1 - b1) * g + b1 * mu[k]
                nu[k] = (1 - b2) * g ** 2 + b2 * nu[k]
                update = (mu[k] / c1) / (torch.sqrt(nu[k] / c2) + hp["eps"])
                p.add_(-lr * (update + hp["weight_decay"] * p))
        del x0, loss, grads
    out["change"] = {f"{t}.{ab}": float((params[t][ab].detach() - lora0[t][ab]).norm())
                     for t, ab in leaves}
    return out

