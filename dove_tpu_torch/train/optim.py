"""Learning-rate schedules and the optimizers, with global-norm clipping and
gradient accumulation, as the JAX package builds them on optax.

Counterpart of ``dove_tpu/train/optim.py`` (``make_lr_schedule``,
``make_optimizer``). A schedule maps the number of updates made so far
(0 on the first step) to a learning rate, with optax's value at every count,
so a warmup's first step has lr 0. Every optimizer is
``optax.chain(clip_by_global_norm(max_norm), <optimizer>)`` step for step:
optax's clip scales by ``max_norm / norm`` only when ``norm >= max_norm``
(``torch.nn.utils.clip_grad_norm_`` divides by ``norm + 1e-6`` and is a
different function). The optimizers, each on the tensors it is given as
leaves (the LoRA tree's stacked ``[L, ...]`` leaves are the JAX package's
own; under SFT the DiT's per-layer tensors in torch layout are):

  * ``adamw`` / ``adam``: the moments keep the parameters' dtype, the bias
    corrections are taken in fp32, and AdamW adds ``weight_decay * param`` to
    the Adam direction before the learning rate scales it;
  * ``came`` (:class:`Came`): an Adafactor-style second moment factored over
    the last two dims (leading dims are batch), the RMS clip, an fp32 first
    moment, and the factored confidence rescale;
  * ``adamw-8bit`` / ``adam-8bit`` (:class:`AdamW8bit`): both moments stored
    as linear per-block codes (int8 m, uint8 sqrt(v); fp32 scales per block
    of 2048);
  * ``adamw-4bit`` / ``adam-4bit`` (:class:`AdamW4bit`): the same with the
    JAX package's non-linear 16-level codebooks, blocks of 128, two codes
    packed per byte; the nearest code is found by a search over the sorted
    codebook that breaks ties to the lower code, as ``argmin`` does, so no
    ``[n, 16]`` distance tensor is made;
  * ``prodigy`` (:class:`Prodigy`): ``optax.contrib.prodigy``'s update with
    its defaults (beta3 = sqrt(beta2), d0 = 1e-6), the schedule as its
    learning rate.

:class:`MultiSteps` is ``optax.MultiSteps(inner, k)``: the running mean of
k micro-gradients, the inner chain (clip included) applied to the mean once
every k calls. Each optimizer's ``state_dict`` holds tensors and ints only,
so ``train/checkpointing.py`` saves and restores it exactly.

Sharded parameters (``init(params, splits)``: a ``parallel.tp.Split`` for
each tensor that FSDP or tensor parallelism cuts over the "model" group,
None for one every rank holds whole) give one device's result, as GSPMD
gives it to the JAX package:

  * the global norm (``norm_fn``) sums the shards' squares over the group
    and counts a whole tensor once;
  * state that mirrors a parameter elementwise keeps its shard (Adam's
    moments, CAME's ``m``, Prodigy's four tensors, the accumulator:
    ``_shard_keys``);
  * CAME's factored statistics and its RMS clip, and the 8- and 4-bit block
    codes, are taken over the whole tensor: each split gradient is gathered
    (an all-gather of one tensor at a time), the statistics and codes are
    whole and replicated on every rank, and each rank applies its slice of
    the step. CAME also gathers ``m`` for its instability statistic;
  * Prodigy's two sums over every parameter add the shards' partial sums
    over the group and count a whole tensor once.

``map_shards`` applies a function to the mirrored state of the split
tensors: the trainer gathers it into a checkpoint, which then holds the
whole state and restores under any layout, and cuts it back.
"""

from __future__ import annotations

import math
from typing import Callable

import numpy as np
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




def _model_sum(terms: list[torch.Tensor], splits: list) -> torch.Tensor:
    """The sum over the whole model of one term per tensor: a split tensor's
    terms (each rank's part) are summed over its group, a whole tensor's (the
    same on every rank) counted once."""
    split = [sp for sp in splits if sp is not None]
    if not split:
        return sum(terms)
    whole = sum((t for t, sp in zip(terms, splits) if sp is None), torch.zeros_like(terms[0]))
    part = sum((t for t, sp in zip(terms, splits) if sp is not None),
               torch.zeros_like(terms[0]))
    torch.distributed.all_reduce(part, group=split[0].g.group)
    return whole + part


def _whole(t: torch.Tensor, sp) -> torch.Tensor:
    """The whole tensor of which ``t`` is this rank's part."""
    return t if sp is None else sp.gather(t)


def _part(t: torch.Tensor, sp) -> torch.Tensor:
    """This rank's part of the whole tensor ``t``."""
    return t if sp is None else sp.take(t)


def _whole_shape(p: torch.Tensor, sp) -> tuple:
    return tuple(p.shape) if sp is None else tuple(sp.shape)


def _bias_correction(beta: float, count: int) -> torch.Tensor:
    """1 - beta**count in fp32, as optax takes it."""
    return 1.0 - torch.tensor(beta, dtype=torch.float32) ** count


class _Chain:
    """optax.chain(clip_by_global_norm(max_grad_norm), <optimizer>).

    ``step(params, grads)`` updates the parameters in place (under no_grad)
    and returns the gradients' global norm before clipping, the number the
    trainer logs. Subclasses name their state tensors in ``_state_keys``
    (each a list with one entry per parameter, or one tensor) and implement
    ``_init`` and ``_update``."""

    _state_keys: tuple[str, ...] = ()
    # the state lists whose tensors mirror their parameter elementwise (a
    # split parameter's keep its shard)
    _shard_keys: tuple[str, ...] = ()

    def __init__(self, lr_schedule: Schedule, max_grad_norm: float | None = None):
        self.lr_schedule = lr_schedule
        self.max_grad_norm = max_grad_norm
        self.count = 0
        self.splits: list = []

    def init(self, params: list[torch.Tensor], splits: list | None = None) -> None:
        """The state of ``params``, this rank's tensors; ``splits`` gives
        each one's ``Split`` over the "model" group, or None where it is
        whole."""
        self.count = 0
        self.splits = list(splits) if splits is not None else [None] * len(params)
        self._init(params)

    def norm_fn(self, grads: list[torch.Tensor]) -> torch.Tensor:
        """The gradients' global norm over the whole model (optax.global_norm:
        the sqrt of the sum of squares, in fp32)."""
        return torch.sqrt(_model_sum([g.float().square().sum() for g in grads], self.splits))

    def map_shards(self, state: dict, fn) -> dict:
        """``state`` (a ``state_dict``) with ``fn(split, tensor)`` applied
        to the mirrored tensors of the split parameters."""
        out = dict(state)
        for k in self._shard_keys:
            out[k] = [t if sp is None else fn(sp, t) for sp, t in zip(self.splits, state[k])]
        return out

    def _init(self, params: list[torch.Tensor]) -> None:
        raise NotImplementedError

    def _update(self, params, grads, lr: float) -> None:
        raise NotImplementedError

    @torch.no_grad()
    def step(self, params: list[torch.Tensor], grads: list[torch.Tensor]) -> torch.Tensor:
        norm = self.norm_fn(grads)
        if self.max_grad_norm is not None and self.max_grad_norm > 0:
            # a device-side select: nothing here waits for the norm
            clip = norm >= self.max_grad_norm
            grads = [torch.where(clip, g / norm.to(g.dtype) * self.max_grad_norm, g)
                     for g in grads]
        lr = self.lr_schedule(self.count)
        self.count += 1
        self._update(params, grads, lr)
        return norm

    def state_dict(self) -> dict:
        out = {"count": self.count}
        for k in self._state_keys:
            v = getattr(self, k)
            out[k] = list(v) if isinstance(v, list) else v
        return out

    def load_state_dict(self, state: dict) -> None:
        for k in self._state_keys:
            dst, src = getattr(self, k), state[k]
            if isinstance(dst, list):
                if len(src) != len(dst):
                    raise ValueError(f"optimizer state {k} holds {len(src)} tensors, "
                                     f"the parameters {len(dst)}")
            else:
                dst, src = [dst], [src]
            for d, s in zip(dst, src):
                if d.shape != s.shape:
                    raise ValueError(f"{k}: shape {tuple(s.shape)} != {tuple(d.shape)}")
                d.copy_(s)
        self.count = int(state["count"])

    def state_bytes(self) -> int:
        """The bytes the optimizer's state tensors hold."""
        total = 0
        for k in self._state_keys:
            v = getattr(self, k)
            for t in (v if isinstance(v, list) else [v]):
                total += t.numel() * t.element_size()
        return total


class Adam(_Chain):
    """optax.chain(clip_by_global_norm(max_grad_norm), adam or adamw). The
    state is the update count and the two moments."""

    _state_keys = ("mu", "nu")
    _shard_keys = ("mu", "nu")

    def __init__(self, lr_schedule: Schedule, b1: float, b2: float, eps: float,
                 weight_decay: float = 0.0, max_grad_norm: float | None = None):
        super().__init__(lr_schedule, max_grad_norm)
        self.b1, self.b2, self.eps = b1, b2, eps
        self.weight_decay = weight_decay
        self.mu: list[torch.Tensor] = []
        self.nu: list[torch.Tensor] = []

    def _init(self, params: list[torch.Tensor]) -> None:
        self.mu = [torch.zeros_like(p, memory_format=torch.contiguous_format)
                   for p in params]
        self.nu = [torch.zeros_like(p, memory_format=torch.contiguous_format)
                   for p in params]

    def _update(self, params, grads, lr: float) -> None:
        c1 = _bias_correction(self.b1, self.count)
        c2 = _bias_correction(self.b2, self.count)
        for p, g, mu, nu in zip(params, grads, self.mu, self.nu):
            mu.copy_((1 - self.b1) * g + self.b1 * mu)
            nu.copy_((1 - self.b2) * g**2 + self.b2 * nu)
            update = (mu / c1.to(mu.dtype)) / (torch.sqrt(nu / c2.to(nu.dtype)) + self.eps)
            if self.weight_decay:
                update = update + self.weight_decay * p
            p.copy_(p + (-lr) * update)


def _apply(p: torch.Tensor, g: torch.Tensor, step: torch.Tensor, lr: float,
           weight_decay: float) -> None:
    """The shared tail of the JAX package's own optimizers, one tensor at a
    time (so no fp32 step of the whole model is held): the decoupled decay
    ``step + weight_decay * param`` in fp32, the update ``-lr * step`` cast
    to the gradient's dtype, added to the parameter."""
    if weight_decay:
        step = step + weight_decay * p.float()
    p.copy_(p + (-lr * step).to(g.dtype))


class Came(_Chain):
    """CAME (the JAX package's ``came``): per leaf of ndim >= 2, the second
    moment and the instability (u - m)^2 are factored over the last two dims
    (row means ``vr``/``ur`` over the last dim, column means ``vc``/``uc``
    over the one before; leading dims are batch); the normalized gradient is
    RMS-clipped and folded into the fp32 first moment ``m``, which the
    factored confidence then rescales. Vectors keep an unfactored second
    moment and take ``m`` as the step. The state keeps the JAX package's
    shapes, the whole tensor's for the statistics of a split parameter."""

    _state_keys = ("m", "vr", "vc", "ur", "uc")
    _shard_keys = ("m",)

    def __init__(self, lr_schedule: Schedule, b1: float = 0.9, b2: float = 0.999,
                 b3: float = 0.9999, eps1: float = 1e-30, eps2: float = 1e-16,
                 clip_threshold: float = 1.0, weight_decay: float = 0.0,
                 max_grad_norm: float | None = None):
        super().__init__(lr_schedule, max_grad_norm)
        self.b1, self.b2, self.b3 = b1, b2, b3
        self.eps1, self.eps2 = eps1, eps2
        self.clip_threshold = clip_threshold
        self.weight_decay = weight_decay

    def _init(self, params: list[torch.Tensor]) -> None:
        def f32(shape, p):
            return torch.zeros(shape, dtype=torch.float32, device=p.device)

        shapes = [_whole_shape(p, sp) for p, sp in zip(params, self.splits)]
        self.m = [f32(p.shape, p) for p in params]
        self.vr = [f32(s[:-1] if len(s) >= 2 else s, p) for s, p in zip(shapes, params)]
        self.vc = [f32(s[:-2] + s[-1:] if len(s) >= 2 else (), p)
                   for s, p in zip(shapes, params)]
        self.ur = [f32(s[:-1] if len(s) >= 2 else s, p) for s, p in zip(shapes, params)]
        self.uc = [f32(s[:-2] + s[-1:] if len(s) >= 2 else (), p)
                   for s, p in zip(shapes, params)]

    @staticmethod
    def _rsqrt_approx(r: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
        """rsqrt(r c / mean(r)) taken per factor, rsqrt(r / mean(r)) times
        rsqrt(c): the product first would underflow fp32 for a zero-gradient
        leaf (r c ~ 1e-66 -> 0 -> inf -> 0 * inf = NaN)."""
        denom = r.mean(dim=-1, keepdim=True).clamp_min(1e-38)
        return torch.rsqrt(r / denom)[..., None] * torch.rsqrt(c)[..., None, :]

    def _update(self, params, grads, lr: float) -> None:
        b1, b2, b3 = self.b1, self.b2, self.b3
        for i, (p, g_in) in enumerate(zip(params, grads)):
            # g and u whole (gathered where the parameter is split), m this
            # rank's part
            sp = self.splits[i]
            g = _whole(g_in.float(), sp)
            vr, vc, m = self.vr[i], self.vc[i], self.m[i]
            g2 = g * g + self.eps1
            if g.ndim >= 2:
                vr.copy_(b2 * vr + (1 - b2) * g2.mean(dim=-1))
                vc.copy_(b2 * vc + (1 - b2) * g2.mean(dim=-2))
                u = g * self._rsqrt_approx(vr, vc)
            else:
                vr.copy_(b2 * vr + (1 - b2) * g2)
                u = g * torch.rsqrt(vr)
            rms = torch.sqrt((u * u).mean() + 1e-38)
            u = u / torch.clamp_min(rms / self.clip_threshold, 1.0)
            m.copy_(b1 * m + (1 - b1) * _part(u, sp))
            if g.ndim >= 2:
                inst = (u - _whole(m, sp)) ** 2 + self.eps2
                ur, uc = self.ur[i], self.uc[i]
                ur.copy_(b3 * ur + (1 - b3) * inst.mean(dim=-1))
                uc.copy_(b3 * uc + (1 - b3) * inst.mean(dim=-2))
                step = m * _part(self._rsqrt_approx(ur, uc), sp)
            else:
                step = m
            _apply(p, g_in, step, lr, self.weight_decay)


class _BlockCodes:
    """Moments stored as per-block codes: each tensor is flattened, padded
    with zeros to whole blocks of ``block_size``, and each block keeps one
    fp32 scale (its absmax, or max for the non-negative stream) beside its
    codes."""

    def __init__(self, block_size: int):
        self.block_size = block_size

    def blocks(self, x: torch.Tensor) -> torch.Tensor:
        flat = x.reshape(-1)
        pad = (-flat.numel()) % self.block_size
        return torch.nn.functional.pad(flat, (0, pad)).reshape(-1, self.block_size)

    def n_blocks(self, numel: int) -> int:
        return -(-max(numel, 1) // self.block_size)

    @staticmethod
    def values(vals: torch.Tensor, scale: torch.Tensor, shape) -> torch.Tensor:
        flat = (vals * scale[:, None]).reshape(-1)
        return flat[:math.prod(shape)].reshape(shape)


class _LowBitAdamW(_Chain):
    """AdamW whose two moments live as block codes between steps: each
    update decodes m and sqrt(v), steps in fp32 as Adam does, and re-encodes
    m and sqrt(v) (storing sqrt(v) spends the code's range where rsqrt is
    sensitive). Subclasses give the code: ``_encode(x, signed)`` ->
    (codes, scales) and ``_decode(codes, scales, shape, signed)``. The codes
    of a split parameter are the whole tensor's."""

    _state_keys = ("m_q", "m_scale", "v_q", "v_scale")

    def __init__(self, lr_schedule: Schedule, b1: float = 0.9, b2: float = 0.999,
                 eps: float = 1e-8, weight_decay: float = 0.0,
                 block_size: int = 2048, max_grad_norm: float | None = None):
        super().__init__(lr_schedule, max_grad_norm)
        self.b1, self.b2, self.eps = b1, b2, eps
        self.weight_decay = weight_decay
        self.codes = _BlockCodes(block_size)

    def _code_shape(self, numel: int) -> tuple[int, int]:
        return (self.codes.n_blocks(numel), self.codes.block_size)

    def _init(self, params: list[torch.Tensor]) -> None:
        numels = [math.prod(_whole_shape(p, sp)) for p, sp in zip(params, self.splits)]

        def zeros(n, p, dtype):
            return torch.zeros(self._code_shape(n), dtype=dtype, device=p.device)

        def scales(n, p):
            return torch.zeros(self.codes.n_blocks(n), dtype=torch.float32, device=p.device)

        self.m_q = [zeros(n, p, self._m_dtype) for n, p in zip(numels, params)]
        self.v_q = [zeros(n, p, torch.uint8) for n, p in zip(numels, params)]
        self.m_scale = [scales(n, p) for n, p in zip(numels, params)]
        self.v_scale = [scales(n, p) for n, p in zip(numels, params)]

    def _update(self, params, grads, lr: float) -> None:
        b1, b2 = self.b1, self.b2
        c1 = _bias_correction(b1, self.count)
        c2 = _bias_correction(b2, self.count)
        for i, (p, g) in enumerate(zip(params, grads)):
            # the whole gradient (gathered where the parameter is split):
            # the codes are the whole tensor's, the step is this rank's part
            sp = self.splits[i]
            gf = _whole(g, sp).float()
            m = self._decode(self.m_q[i], self.m_scale[i], gf.shape, True)
            v_sqrt = self._decode(self.v_q[i], self.v_scale[i], gf.shape, False)
            v = v_sqrt * v_sqrt
            m = b1 * m + (1 - b1) * gf
            v = b2 * v + (1 - b2) * gf * gf
            _apply(p, g, _part((m / c1) / (torch.sqrt(v / c2) + self.eps), sp), lr,
                   self.weight_decay)
            for (q, s), dq, ds in ((self._encode(m, True), self.m_q[i], self.m_scale[i]),
                                   (self._encode(torch.sqrt(v), False),
                                    self.v_q[i], self.v_scale[i])):
                dq.copy_(q)
                ds.copy_(s)


class AdamW8bit(_LowBitAdamW):
    """The JAX package's ``adamw_8bit``: linear codes per block of 2048, m as
    int8 in [-127, 127] of its block's absmax, sqrt(v) as uint8 in [0, 255]
    of its block's max; about 2 bytes a parameter."""

    _m_dtype = torch.int8

    def _encode(self, x: torch.Tensor, signed: bool):
        blocks = self.codes.blocks(x)
        if signed:
            scale = blocks.abs().amax(dim=1, keepdim=True) / 127.0
            lo, hi, dtype = -127, 127, torch.int8
        else:
            scale = blocks.amax(dim=1, keepdim=True) / 255.0
            lo, hi, dtype = 0, 255, torch.uint8
        q = torch.round(blocks / scale.clamp_min(1e-38)).clamp_(lo, hi).to(dtype)
        return q, scale[:, 0]

    def _decode(self, q, scale, shape, signed: bool):
        return self.codes.values(q.float(), scale, shape)


# 4-bit codebooks (the JAX package's, after Li et al. 2023, "Memory Efficient
# Optimizers with 4-bit States"): the first moment on a dynamic-exponent map
# (0 and +-2^-k octaves), sqrt(v) on sqrt(2)-spaced levels; both ascending.
_CB4_SIGNED = np.array(
    [-(2.0 ** -k) for k in range(7)] + [0.0] + [2.0 ** -(7 - k) for k in range(8)],
    np.float32)
_CB4_UNSIGNED = np.array(
    [0.0] + [2.0 ** (-(14 - k) / 2.0) for k in range(15)], np.float32)


def nearest_code(norm: torch.Tensor, codebook: torch.Tensor) -> torch.Tensor:
    """The index of the codebook value nearest each entry of ``norm``
    (ascending ``codebook``), the lower one on a tie: ``argmin |norm - cb|``
    without its [n, 16] distances. Only the two codes around an entry can be
    nearest (fp32 subtraction is monotone), so their distances decide."""
    hi = torch.searchsorted(codebook, norm.contiguous()).clamp_(1, codebook.numel() - 1)
    lo = hi - 1
    d_lo = (norm - codebook[lo]).abs()
    d_hi = (norm - codebook[hi]).abs()
    return torch.where(d_hi < d_lo, hi, lo).to(torch.uint8)


class AdamW4bit(_LowBitAdamW):
    """The JAX package's ``adamw_4bit``: the 16-level codebooks, blocks of
    128 normalized by their absmax (max for sqrt(v)), two codes a byte (the
    even entry in the low nibble); about 1.06 bytes a parameter (two
    nibble streams and their scales)."""

    _m_dtype = torch.uint8

    def __init__(self, *args, block_size: int = 128, **kw):
        if block_size % 2:
            raise ValueError("block_size must be even (two codes pack per byte)")
        super().__init__(*args, block_size=block_size, **kw)
        self._books: dict = {}

    def _code_shape(self, numel: int) -> tuple[int, int]:
        return (self.codes.n_blocks(numel), self.codes.block_size // 2)

    def _book(self, signed: bool, device) -> torch.Tensor:
        key = (signed, str(device))
        if key not in self._books:
            self._books[key] = torch.from_numpy(
                _CB4_SIGNED if signed else _CB4_UNSIGNED).to(device)
        return self._books[key]

    def _encode(self, x: torch.Tensor, signed: bool):
        blocks = self.codes.blocks(x)
        scale = (blocks.abs() if signed else blocks).amax(dim=1, keepdim=True)
        codes = nearest_code(blocks / scale.clamp_min(1e-38),
                             self._book(signed, x.device))
        return codes[:, 0::2] | (codes[:, 1::2] << 4), scale[:, 0]

    def _decode(self, packed, scale, shape, signed: bool):
        codes = torch.stack([packed & 0xF, packed >> 4], dim=-1).reshape(packed.shape[0], -1)
        vals = self._book(signed, packed.device)[codes.long()]
        return self.codes.values(vals, scale, shape)


class Prodigy(_Chain):
    """``optax.contrib.prodigy`` (D-Adapt AdamW with Prodigy's weighting):
    the step is ``d * lr(count)`` times Adam's bias corrections, where d, the
    distance estimate ``estim_lr``, only grows. State: the two moments of the
    d-scaled gradients, the weighted gradient sum, the initial parameters,
    and the two scalars, in the parameters' lowest float dtype."""

    _state_keys = ("exp_avg", "exp_avg_sq", "grad_sum", "params0", "estim_lr",
                   "numerator_weighted")
    _shard_keys = ("exp_avg", "exp_avg_sq", "grad_sum", "params0")

    def __init__(self, lr_schedule: Schedule, betas: tuple[float, float] = (0.9, 0.999),
                 beta3: float | None = None, eps: float = 1e-8,
                 estim_lr0: float = 1e-6, estim_lr_coef: float = 1.0,
                 weight_decay: float = 0.0, max_grad_norm: float | None = None):
        super().__init__(lr_schedule, max_grad_norm)
        self.b1, self.b2 = betas
        self.b3 = self.b2**0.5 if beta3 is None else beta3
        self.eps = eps
        self.estim_lr0, self.estim_lr_coef = estim_lr0, estim_lr_coef
        self.weight_decay = weight_decay

    def _init(self, params: list[torch.Tensor]) -> None:
        self.exp_avg = [torch.zeros_like(p) for p in params]
        self.exp_avg_sq = [torch.zeros_like(p) for p in params]
        self.grad_sum = [torch.zeros_like(p) for p in params]
        self.params0 = [p.detach().clone() for p in params]
        dtype = min((p.dtype for p in params), key=lambda d: torch.finfo(d).bits)
        device = params[0].device
        self.estim_lr = torch.tensor(self.estim_lr0, dtype=dtype, device=device)
        self.numerator_weighted = torch.zeros((), dtype=dtype, device=device)

    def _update(self, params, grads, lr: float) -> None:
        b1, b2, b3 = self.b1, self.b2, self.b3
        d = self.estim_lr
        bc = (1 - torch.tensor(b2, dtype=torch.float32) ** self.count) ** 0.5 / (
            _bias_correction(b1, self.count))
        dlr = (d * lr * bc.to(d.device)).to(d.dtype)
        numerator = _model_sum(
            [torch.vdot(g.reshape(-1).float(), (p0 - p).reshape(-1).float())
             for g, p0, p in zip(grads, self.params0, params)], self.splits)
        sums = []
        for g, ea, eas, gs in zip(grads, self.exp_avg, self.exp_avg_sq, self.grad_sum):
            dg = d * g
            ea.copy_(b1 * ea + (1 - b1) * dg)
            eas.copy_(b2 * eas + (1 - b2) * dg * dg)
            gs.copy_(b3 * gs + dlr * dg / self.estim_lr0)
            sums.append(gs.abs().sum())
        denominator = _model_sum(sums, self.splits)
        nw = b3 * self.numerator_weighted + (d / self.estim_lr0) * dlr * numerator
        self.numerator_weighted.copy_(nw)
        self.estim_lr = torch.maximum(d, self.estim_lr_coef * nw / denominator).to(d.dtype)
        for p, ea, eas in zip(params, self.exp_avg, self.exp_avg_sq):
            p.copy_(p + (-self.weight_decay * dlr * p
                         - dlr * ea / (torch.sqrt(eas) + self.estim_lr * self.eps)))


class MultiSteps:
    """``optax.MultiSteps(inner, k)``: each call adds its gradients to the
    running mean ``acc + (g - acc) / (n + 1)`` (optax's form); the k-th call
    hands the mean to the inner optimizer (its clip, count and schedule move
    only then) and zeroes the accumulator. ``step`` returns the global norm of
    the call's own gradients, the number the trainer logs. The state holds
    the accumulator, the call count within the window (``mini_step``) and
    the inner state."""

    def __init__(self, inner: _Chain, every_k: int):
        if every_k < 1:
            raise ValueError(f"every_k must be >= 1, got {every_k}")
        self.inner, self.every_k = inner, every_k
        self.mini_step = 0
        self.gradient_step = 0
        self.acc: list[torch.Tensor] = []

    @property
    def count(self) -> int:
        return self.inner.count

    @property
    def splits(self) -> list:
        return self.inner.splits

    def init(self, params: list[torch.Tensor], splits: list | None = None) -> None:
        self.inner.init(params, splits)
        self.mini_step = self.gradient_step = 0
        self.acc = [torch.zeros_like(p) for p in params]

    def map_shards(self, state: dict, fn) -> dict:
        """As the inner optimizer's; the accumulator mirrors the parameters."""
        return dict(state, acc=[t if sp is None else fn(sp, t)
                                for sp, t in zip(self.splits, state["acc"])],
                    inner=self.inner.map_shards(state["inner"], fn))

    @torch.no_grad()
    def step(self, params: list[torch.Tensor], grads: list[torch.Tensor]) -> torch.Tensor:
        n = self.mini_step
        for acc, g in zip(self.acc, grads):
            acc.copy_(acc + (g - acc) / (n + 1))
        self.mini_step = (n + 1) % self.every_k
        if self.mini_step == 0:
            self.inner.step(params, self.acc)
            self.gradient_step += 1
            for acc in self.acc:
                acc.zero_()
        return self.inner.norm_fn(grads)

    def state_dict(self) -> dict:
        return {"mini_step": self.mini_step, "gradient_step": self.gradient_step,
                "acc": list(self.acc), "inner": self.inner.state_dict()}

    def load_state_dict(self, state: dict) -> None:
        if len(state["acc"]) != len(self.acc):
            raise ValueError(f"accumulator holds {len(state['acc'])} tensors, "
                             f"the parameters {len(self.acc)}")
        for dst, src in zip(self.acc, state["acc"]):
            dst.copy_(src)
        self.inner.load_state_dict(state["inner"])
        self.mini_step = int(state["mini_step"])
        self.gradient_step = int(state["gradient_step"])

    def state_bytes(self) -> int:
        return self.inner.state_bytes() + sum(
            a.numel() * a.element_size() for a in self.acc)


OPTIMIZERS = ("adamw", "adam", "adamw-8bit", "adam-8bit", "adamw-4bit",
              "adam-4bit", "prodigy", "came")


def make_optimizer(
    name: str,
    lr_schedule: Schedule,
    *,
    betas: tuple[float, float] = (0.9, 0.95),
    beta3: float = 0.9999,
    eps: float = 1e-8,
    weight_decay: float = 1e-4,
    max_grad_norm: float | None = 1.0,
) -> _Chain:
    """The JAX package's ``make_optimizer``: ``name`` as it spells it
    (underscores read as dashes), the clip first in the chain."""
    name = name.lower().replace("_", "-")
    clip = dict(max_grad_norm=max_grad_norm)
    # the "adam" spellings are the same optimizers without the decay
    decay = 0.0 if name in ("adam", "adam-8bit", "adam-4bit") else weight_decay
    if name in ("adamw", "adam"):
        return Adam(lr_schedule, betas[0], betas[1], eps, weight_decay=decay, **clip)
    if name in ("adamw-8bit", "adam-8bit"):
        return AdamW8bit(lr_schedule, betas[0], betas[1], eps, weight_decay=decay, **clip)
    if name in ("adamw-4bit", "adam-4bit"):
        return AdamW4bit(lr_schedule, betas[0], betas[1], eps, weight_decay=decay, **clip)
    if name == "prodigy":
        return Prodigy(lr_schedule, betas=betas, eps=eps, weight_decay=weight_decay,
                       **clip)
    if name == "came":
        # the reference pins eps = (1e-30, 1e-16)
        return Came(lr_schedule, betas[0], betas[1], beta3, weight_decay=weight_decay,
                    **clip)
    raise ValueError(f"unsupported optimizer: {name}")
