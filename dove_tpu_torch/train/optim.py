"""Learning-rate schedules and the AdamW / Adam optimizers with global-norm
clipping, as the JAX package builds them on optax.

Counterpart of ``dove_tpu/train/optim.py`` (``make_lr_schedule``,
``make_optimizer``). A schedule maps the number of updates made so far
(0 on the first step) to a learning rate, with optax's value at every count,
so a warmup's first step has lr 0. The optimizer is
``optax.chain(clip_by_global_norm(max_norm), adamw(...))`` step for step:
optax's clip scales by ``max_norm / norm`` only when ``norm >= max_norm``
(``torch.nn.utils.clip_grad_norm_`` divides by ``norm + 1e-6`` and is a
different function), Adam's moments keep the parameters' dtype, the bias
corrections are taken in fp32, and AdamW adds ``weight_decay * param`` to
the Adam direction before the learning rate scales it.

CAME, Prodigy and the 8- and 4-bit AdamW variants are not ported (ROADMAP
queue A).
"""

from __future__ import annotations

import math
from typing import Callable

import torch

Schedule = Callable[[int], float]


def _polynomial(init: float, end: float, power: float, steps: int) -> Schedule:
    """optax.polynomial_schedule (transition_begin 0)."""
    if steps <= 0:
        return lambda count: init

    def schedule(count: int) -> float:
        frac = 1.0 - min(max(count, 0), steps) / steps
        return (init - end) * frac**power + end

    return schedule


def _linear(init: float, end: float, steps: int) -> Schedule:
    return _polynomial(init, end, 1.0, steps)


def _constant(value: float) -> Schedule:
    return lambda count: value


def _cosine_decay(init: float, decay_steps: int, alpha: float = 0.0) -> Schedule:
    """optax.cosine_decay_schedule (exponent 1)."""
    if not decay_steps > 0:
        raise ValueError(
            f"the cosine decay requires positive decay_steps, got {decay_steps}")

    def schedule(count: int) -> float:
        cosine = 0.5 * (1.0 + math.cos(math.pi * min(count, decay_steps) / decay_steps))
        return init * ((1.0 - alpha) * cosine + alpha)

    return schedule


def _join(schedules: list[Schedule], boundaries: list[int]) -> Schedule:
    """optax.join_schedules: after each boundary the next schedule runs on
    the count since that boundary."""

    def schedule(count: int) -> float:
        out = schedules[0](count)
        for boundary, fn in zip(boundaries, schedules[1:]):
            if count >= boundary:
                out = fn(count - boundary)
        return out

    return schedule


def make_lr_schedule(
    lr: float,
    warmup_steps: int = 0,
    total_steps: int | None = None,
    kind: str = "constant_with_warmup",
    num_cycles: int = 1,
    power: float = 1.0,
) -> Schedule:
    if kind in ("constant", "constant_with_warmup"):
        if warmup_steps <= 0:
            return _constant(lr)
        return _join([_linear(0.0, lr, warmup_steps), _constant(lr)], [warmup_steps])
    if kind in ("linear", "warmup_decay"):
        if total_steps is None:
            raise ValueError("warmup_decay schedule needs total_steps")
        return _join(
            [_linear(0.0, lr, max(warmup_steps, 1)),
             _linear(lr, 0.0, max(total_steps - warmup_steps, 1))],
            [warmup_steps],
        )
    if kind == "cosine":
        if total_steps is None:
            raise ValueError("cosine schedule needs total_steps")
        # optax.warmup_cosine_decay_schedule(0, lr, max(W, 1), T)
        warm = max(warmup_steps, 1)
        return _join([_linear(0.0, lr, warm), _cosine_decay(lr, total_steps - warm)],
                     [warm])
    if kind == "cosine_with_restarts":
        if total_steps is None:
            raise ValueError("cosine_with_restarts needs total_steps")
        decay = max(total_steps - warmup_steps, 1)
        per = max(decay // max(num_cycles, 1), 1)
        cosines = [_cosine_decay(lr, per) for _ in range(max(num_cycles, 1))]
        bounds = [warmup_steps + per * (i + 1) for i in range(len(cosines) - 1)]
        return _join([_linear(0.0, lr, max(warmup_steps, 1))] + cosines,
                     [warmup_steps] + bounds)
    if kind == "polynomial":
        if total_steps is None:
            raise ValueError("polynomial schedule needs total_steps")
        return _join(
            [_linear(0.0, lr, max(warmup_steps, 1)),
             _polynomial(lr, 0.0, power, max(total_steps - warmup_steps, 1))],
            [warmup_steps],
        )
    raise ValueError(f"unknown lr schedule: {kind}")


def global_norm(tensors: list[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares of every element, in fp32 (optax.global_norm)."""
    return torch.sqrt(sum(t.float().square().sum() for t in tensors))


class Adam:
    """optax.chain(clip_by_global_norm(max_grad_norm), adam or adamw).

    ``step(params, grads)`` updates the parameters in place (under no_grad)
    and returns the gradients' global norm before clipping, the number the
    trainer logs. The state is the update count and the two moments."""

    def __init__(self, lr_schedule: Schedule, b1: float, b2: float, eps: float,
                 weight_decay: float = 0.0, max_grad_norm: float | None = None):
        self.lr_schedule = lr_schedule
        self.b1, self.b2, self.eps = b1, b2, eps
        self.weight_decay = weight_decay
        self.max_grad_norm = max_grad_norm
        self.count = 0
        self.mu: list[torch.Tensor] = []
        self.nu: list[torch.Tensor] = []

    def init(self, params: list[torch.Tensor]) -> None:
        self.count = 0
        self.mu = [torch.zeros_like(p, memory_format=torch.contiguous_format)
                   for p in params]
        self.nu = [torch.zeros_like(p, memory_format=torch.contiguous_format)
                   for p in params]

    @torch.no_grad()
    def step(self, params: list[torch.Tensor], grads: list[torch.Tensor]) -> torch.Tensor:
        norm = global_norm(grads)
        if self.max_grad_norm is not None and self.max_grad_norm > 0:
            # a device-side select: nothing here waits for the norm
            clip = norm >= self.max_grad_norm
            grads = [torch.where(clip, g / norm.to(g.dtype) * self.max_grad_norm, g)
                     for g in grads]
        lr = self.lr_schedule(self.count)
        self.count += 1
        c1 = 1.0 - torch.tensor(self.b1, dtype=torch.float32) ** self.count
        c2 = 1.0 - torch.tensor(self.b2, dtype=torch.float32) ** self.count
        for p, g, mu, nu in zip(params, grads, self.mu, self.nu):
            mu.copy_((1 - self.b1) * g + self.b1 * mu)
            nu.copy_((1 - self.b2) * g**2 + self.b2 * nu)
            update = (mu / c1.to(mu.dtype)) / (torch.sqrt(nu / c2.to(nu.dtype)) + self.eps)
            if self.weight_decay:
                update = update + self.weight_decay * p
            p.copy_(p + (-lr) * update)
        return norm

    def state_dict(self) -> dict:
        return {"count": self.count, "mu": list(self.mu), "nu": list(self.nu)}

    def load_state_dict(self, state: dict) -> None:
        if len(state["mu"]) != len(self.mu):
            raise ValueError(f"optimizer state holds {len(state['mu'])} moments, "
                             f"the parameters {len(self.mu)}")
        self.count = int(state["count"])
        for dst, src in zip(self.mu + self.nu, list(state["mu"]) + list(state["nu"])):
            if dst.shape != src.shape:
                raise ValueError(f"moment shape {tuple(src.shape)} != {tuple(dst.shape)}")
            dst.copy_(src)


def make_optimizer(
    name: str,
    lr_schedule: Schedule,
    *,
    betas: tuple[float, float] = (0.9, 0.95),
    beta3: float = 0.9999,
    eps: float = 1e-8,
    weight_decay: float = 1e-4,
    max_grad_norm: float | None = 1.0,
) -> Adam:
    name = name.lower().replace("_", "-")
    if name in ("came", "prodigy", "adamw-8bit", "adam-8bit", "adamw-4bit",
                "adam-4bit"):
        raise NotImplementedError(
            f"optimizer {name} is not ported yet (ROADMAP queue A: the remaining "
            "optimizers)")
    if name not in ("adamw", "adam"):
        raise ValueError(f"unsupported optimizer: {name}")
    del beta3  # CAME's
    return Adam(lr_schedule, betas[0], betas[1], eps,
                weight_decay=weight_decay if name == "adamw" else 0.0,
                max_grad_norm=max_grad_norm)
