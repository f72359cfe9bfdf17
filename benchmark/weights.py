"""Seeded weights and inputs, made on the device: the same seed, the same tensors.

Every tensor of a model is filled by name and shape from a list of
``(name, shape)`` (the program's module tree gives it, and the reference's
``dit_spec`` / ``vae_spec`` give the same list): biases and the 2B's stored
position table zero, other 1-D tensors (norm gains) one, every other tensor
N(0, 1 / fan_in) with fan_in its elements per output channel. That is the
synthetic scale rule of the JAX package's int8 drift script, which keeps a
42-layer DiT and the 2B in fp16 finite. The normals are drawn in the dtype
the model is served in, in blocks of ``CHUNK`` from one generator on the
device, leaves taken in (fan_in, name) order, so both sides of a comparison
get the same numbers from the same seed.
"""

from __future__ import annotations

import math

import numpy as np
import torch

CHUNK = 1 << 28  # normals per draw: fixed, so the stream never depends on memory
# stream tags under one run seed
DIT, VAE, PROMPT, LORA, CLIP, BATCH = range(6)


def derive(seed: int, *words: int) -> int:
    """A 32-bit seed for one stream of one run seed (any size of int)."""
    return int(np.random.SeedSequence([int(seed), *words]).generate_state(1)[0])


def _fill(name: str, shape: tuple[int, ...]) -> float | None:
    """The constant of a constant tensor, or None for a drawn one."""
    if name.endswith(".bias") or name.endswith("pos_embedding"):
        return 0.0
    if len(shape) == 1:
        return 1.0
    return None


def make(spec, seed: int, stream: int, dtype: torch.dtype, device) -> dict[str, torch.Tensor]:
    """``{name: tensor}`` for ``spec`` [(name, shape)], each tensor its own
    storage (a quantizing program may free what it replaces)."""
    out: dict[str, torch.Tensor] = {}
    drawn = []
    for name, shape in spec:
        shape = tuple(shape)
        const = _fill(name, shape)
        if const is None:
            drawn.append((math.prod(shape[1:]), name, shape))
        else:
            out[name] = torch.full(shape, const, dtype=dtype, device=device)
    gen = torch.Generator(device=device).manual_seed(derive(seed, stream))
    buf, pos = None, CHUNK
    for fan_in, name, shape in sorted(drawn):
        t = torch.empty(shape, dtype=dtype, device=device)
        flat, done, n = t.view(-1), 0, t.numel()
        while done < n:
            if pos == CHUNK:
                buf = torch.randn(CHUNK, generator=gen, dtype=dtype, device=device)
                pos = 0
            take = min(n - done, CHUNK - pos)
            flat[done:done + take] = buf[pos:pos + take]
            done, pos = done + take, pos + take
        out[name] = t.mul_(fan_in ** -0.5)
    return out


def prompt_embedding(seed: int, length: int, dim: int, dtype, device) -> torch.Tensor:
    """The empty-prompt T5 embedding [length, dim], N(0, 1): no T5 checkpoint
    is in the repository."""
    gen = torch.Generator(device=device).manual_seed(derive(seed, PROMPT))
    return torch.randn((length, dim), generator=gen, dtype=torch.float32,
                       device=device).to(dtype)


def lora(seed: int, layers: int, dim: int, rank: int, targets, device):
    """LoRA factors as peft starts them: A ~ N(0, 1/dim) [L, dim, r], B = 0
    [L, r, dim], fp32, one tree {target: {"A", "B"}}."""
    gen = torch.Generator(device=device).manual_seed(derive(seed, LORA))
    a = torch.randn((len(targets), layers, dim, rank), generator=gen,
                    dtype=torch.float32, device=device) / math.sqrt(dim)
    return {t: {"A": a[i].clone(), "B": torch.zeros((layers, rank, dim), device=device)}
            for i, t in enumerate(targets)}


def for_reference(config: dict, seed: int, dtype, device):
    """The same DiT and VAE tensors and prompt embedding, again, for the
    reference (named by its own spec), after setting it to strict float32."""
    from benchmark.reference import models

    models.strict_fp32()
    return (make(models.dit_spec(config["dit"]), seed, DIT, dtype, device),
            make(models.vae_spec(config["vae"]), seed, VAE, dtype, device),
            prompt_embedding(seed, config["dit"]["max_text_seq_length"],
                             config["dit"]["text_embed_dim"], dtype, device))
