"""Tensor-parallel (Megatron-style) and sequence-parallel DiT.

Counterpart of ``dove_tpu/parallel/tp.py``. Each block's matmuls split over
the "model" group:

  * column-parallel (output dim split): ``attn1.to_q/to_k/to_v``,
    ``ff.net.0.proj``;
  * row-parallel (input dim split): ``attn1.to_out.0``, ``ff.net.2``;

so each rank owns heads/tp attention heads (K1, K2 and K1-lse run on them
unchanged) and ff_dim/tp MLP channels, and each block does two all-reduces
(after ``to_out`` and ``net_2``). LayerNorms, adaLN, the patch embedding and
RoPE stay whole on every rank.

The JAX package writes this as ``shard_map`` and lets autodiff transpose the
collectives. Here they are autograd functions (Megatron's f and g):

  * ``copy_to``: identity forward, all-reduce backward, where a tensor that
    every rank holds whole enters rank-local work (the input of a
    column-parallel layer; a parameter that each rank applies to its own
    heads or tokens only), so its gradient sums every rank's part;
  * ``reduce_from``: all-reduce forward, identity backward, after a
    row-parallel layer;
  * ``gather_from``: the sequence-parallel all-gather, whose backward takes
    this rank's slice (the gradient after the gather is the same on every
    rank, since all of them compute what follows).

``torch.distributed.nn.functional.all_reduce`` would all-reduce the gradient
as well, which multiplies a gradient every rank already holds by tp.

Sequence parallelism (``token_shard``): when the batch cannot split over the
"data" ranks (B = 1 on a data x model mesh), those ranks take token slices of
the attention core (with the out-projection) and of the MLP and all-gather
them: attention rows depend only on their own query row, so K and V stay
whole. Exactness: split contractions reorder the fp32 accumulation, so the
output matches one device to float tolerance, not bit for bit.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Any

import torch
import torch.distributed as dist
import torch.nn.functional as F

COL_PARALLEL = ("to_q", "to_k", "to_v", "net_0_proj")
ROW_PARALLEL = ("to_out", "net_2")
# the port's module paths inside a block -> the JAX package's layer names
_LAYER_OF = {
    "attn1.to_q": "to_q", "attn1.to_k": "to_k", "attn1.to_v": "to_v",
    "attn1.to_out.0": "to_out", "ff.net.0.proj": "net_0_proj", "ff.net.2": "net_2",
}
_BLOCK_KEY = re.compile(r"transformer_blocks\.\d+\.(.+)\.(\w+)$")


@dataclasses.dataclass(frozen=True)
class Group:
    """A process group with this rank's index in it and its size."""

    group: Any
    size: int
    rank: int


def validate_tp(cfg, tp: int) -> None:
    """The TP degree must split the heads and both matmul widths evenly."""
    bad = {
        "num_attention_heads": cfg.num_attention_heads % tp,
        "hidden_dim": cfg.hidden_dim % tp,
        "ff_dim": cfg.ff_dim % tp,
    }
    if any(bad.values()):
        raise ValueError(
            f"tensor_parallel={tp} must divide heads={cfg.num_attention_heads}, "
            f"hidden={cfg.hidden_dim}, ff={cfg.ff_dim} (remainders {bad})")


def tp_dim(name: str) -> int | None:
    """The dim along which the DiT tensor ``name`` (a state-dict key) splits
    under TP, or None where it stays whole. Torch keeps linears as [out,
    in], so column-parallel weights, their scales and biases split dim 0 and
    row-parallel weights dim 1; a row-parallel layer's per-output scale and
    bias stay whole (the JAX package's ``dit_tp_specs``)."""
    m = _BLOCK_KEY.search(name)
    if m is None or m.group(1) not in _LAYER_OF:
        return None
    layer, leaf = _LAYER_OF[m.group(1)], m.group(2)
    if layer in COL_PARALLEL:
        return 0
    return 1 if leaf in ("weight", "weight_q") else None


def dit_tp_specs(dit: torch.nn.Module) -> dict[str, int | None]:
    """{state-dict key: split dim or None} for a DiT, bf16 or int8."""
    return {name: tp_dim(name) for name in dit.state_dict()}


def shard_slice(full: torch.Tensor, dim: int, size: int, rank: int) -> torch.Tensor:
    """Rank ``rank``'s part of ``full`` split ``size`` ways along ``dim`` in
    ``torch.chunk``'s sizes (ceil; trailing parts may be short or empty),
    the split that FSDP2 and an even TP split both take."""
    n = full.shape[dim]
    c = -(-n // size)
    lo = min(rank * c, n)
    return full.narrow(dim, lo, min(c, n - lo))


def gather_split(local: torch.Tensor, dim: int, g: Group, full_len: int) -> torch.Tensor:
    """The whole tensor from every rank's ``shard_slice`` part (each padded
    to the common chunk, gathered, cut back to ``full_len``)."""
    c = -(-full_len // g.size)
    pad = c - local.shape[dim]
    if pad:
        widths = [0, 0] * (local.ndim - 1 - dim) + [0, pad]
        local = F.pad(local, widths)
    parts = [torch.empty_like(local) for _ in range(g.size)]
    dist.all_gather(parts, local.contiguous(), group=g.group)
    return torch.cat(parts, dim=dim).narrow(dim, 0, full_len)


@dataclasses.dataclass(frozen=True)
class Split:
    """How one tensor of the whole model is cut over a group: along ``dim``
    in ``shard_slice``'s parts; ``shape`` is the whole tensor's."""

    dim: int
    shape: tuple
    g: Group

    def gather(self, local: torch.Tensor) -> torch.Tensor:
        return gather_split(local, self.dim, self.g, self.shape[self.dim])

    def take(self, full: torch.Tensor) -> torch.Tensor:
        return shard_slice(full, self.dim, self.g.size, self.g.rank)


def opt_state_tp_specs(state: Any, splits: list, shapes: list, fn) -> Any:
    """``fn(split, tensor)`` over the optimizer-state tensors that mirror a
    parameter (the JAX package's rule): entries of a list with one tensor
    per parameter whose shape is that parameter's in ``shapes`` (the local
    shapes to gather, the whole ones to cut). Everything else (counts,
    factored statistics of another shape) passes as it is."""
    n = len(splits)

    def walk(x):
        if isinstance(x, dict):
            return {k: walk(v) for k, v in x.items()}
        if (isinstance(x, list) and len(x) == n
                and all(isinstance(t, torch.Tensor) for t in x)):
            return [fn(sp, t) if sp is not None and tuple(t.shape) == tuple(sh) else t
                    for sp, sh, t in zip(splits, shapes, x)]
        if isinstance(x, list):
            return [walk(v) for v in x]
        return x

    return walk(state)


@torch.no_grad()
def shard_dit_tp(dit: torch.nn.Module, g: Group) -> torch.nn.Module:
    """Keep this rank's TP shard of every split tensor of ``dit`` (in place;
    each rank holds the whole model before) and mark the DiT
    tensor-parallel over ``g``. A DiT already split over a group of this
    size is left as it is."""
    current = getattr(dit, "tp", None)
    if current is not None:
        if current.size != g.size:
            raise ValueError(f"the DiT is split {current.size} ways, not {g.size}")
        return dit
    validate_tp(dit.cfg, g.size)
    for name, dim in dit_tp_specs(dit).items():
        if dim is None:
            continue
        path, leaf = name.rsplit(".", 1)
        mod = dit.get_submodule(path)
        t = getattr(mod, leaf)
        part = shard_slice(t.detach(), dim, g.size, g.rank).clone()
        if isinstance(t, torch.nn.Parameter):
            t.data = part
        else:
            setattr(mod, leaf, part)  # a registered buffer (int8 linears)
        if hasattr(mod, "out_features") and leaf in ("weight", "weight_q"):
            mod.out_features, mod.in_features = part.shape[0], part.shape[1]
    dit.tp = g
    return dit


# ---------------------------------------------------------------------------
# The collectives as autograd functions
# ---------------------------------------------------------------------------

class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        x = x.contiguous().clone()
        dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _GatherFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, g):
        ctx.dim, ctx.g, ctx.n = dim, g, x.shape[dim]
        parts = [torch.empty_like(x) for _ in range(g.size)]
        dist.all_gather(parts, x.contiguous(), group=g.group)
        return torch.cat(parts, dim=dim)

    @staticmethod
    def backward(ctx, grad):
        return grad.narrow(ctx.dim, ctx.g.rank * ctx.n, ctx.n).contiguous(), None, None


def _needs_grad(x: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and x.requires_grad


def copy_to(x, g: Group | None):
    """f: identity forward; the gradient is summed over ``g``."""
    if x is None or g is None or not _needs_grad(x):
        return x
    return _CopyTo.apply(x, g.group)


def reduce_from(x: torch.Tensor, g: Group | None) -> torch.Tensor:
    """g: the sum over ``g`` forward; the gradient passes as it is."""
    if g is None:
        return x
    if _needs_grad(x):
        return _ReduceFrom.apply(x, g.group)
    x = x.contiguous().clone()
    dist.all_reduce(x, group=g.group)
    return x


def gather_from(x: torch.Tensor, dim: int, g: Group) -> torch.Tensor:
    """Every rank's equal-sized ``x`` concatenated along ``dim``, in rank
    order; the gradient takes this rank's slice."""
    return _GatherFrom.apply(x, dim, g)


def token_shard(fn, x: torch.Tensor, sp: Group, dim: int, out_dim: int) -> torch.Tensor:
    """Sequence parallelism: this rank's token slice of ``x`` (zero-padded
    along ``dim`` to a multiple of the group size) through ``fn``, gathered
    along ``out_dim`` and cut back. Padded rows are discarded after the
    gather: redundant compute only."""
    S = x.shape[dim]
    pad = (-S) % sp.size
    if pad:
        widths = [0, 0] * (x.ndim - 1 - dim) + [0, pad]
        x = F.pad(x, widths)
    chunk = (S + pad) // sp.size
    # contiguous: the attention kernels take their q by TMA
    y = gather_from(fn(x.narrow(dim, sp.rank * chunk, chunk).contiguous()), out_dim, sp)
    return y.narrow(out_dim, 0, S) if pad else y


# ---------------------------------------------------------------------------
# The mesh's batch rule
# ---------------------------------------------------------------------------

def batch_rule(mesh, batch: int) -> tuple[Group | None, Group | None]:
    """(batch group, sequence group) of ``make_tp_dit``'s rule: the batch
    splits over the "data" ranks when it divides them; otherwise those ranks
    carry sequence parallelism. Both None on a mesh without data ranks."""
    g = mesh.axis_group("data")
    if g is None:
        return None, None
    return (g, None) if batch % g.size == 0 else (None, g)


def make_tp_dit(mesh, dit: torch.nn.Module, **fwd_kwargs):
    """``(latent, text_embeds, timestep, **kw) -> velocity`` over ``mesh``:
    the DiT split over "model" (``shard_dit_tp``, in place) and the batch
    rule over "data". Every rank passes the whole batch and gets the whole
    output."""
    if mesh.shape["model"] > 1:
        shard_dit_tp(dit, mesh.axis_group("model"))

    def call(latent, text_embeds, timestep, **kw):
        bg, sp = batch_rule(mesh, latent.shape[0])
        kw = {**fwd_kwargs, **kw}
        if bg is None:
            return dit(latent, text_embeds, timestep, sp=sp, **kw)
        n = latent.shape[0] // bg.size

        def part(t):
            return t.narrow(0, bg.rank * n, n)

        out = dit(part(latent), part(text_embeds), part(timestep), **kw)
        return gather_from(out, 0, bg)

    return call
