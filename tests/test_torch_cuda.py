"""Tests of the PyTorch port that need an NVIDIA GPU (marked ``cuda``).

They skip on a machine without one. The machine with the card has no JAX, so
this file imports only torch and dove_tpu_torch, and runs there without the
JAX-loading conftest:

    python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_cuda.py
"""

from __future__ import annotations

import pytest
import torch

from dove_tpu_torch.ops import flash_attention as fa

# bf16 bars, as chip_smoke.py holds K1: the absolute bar of
# tests/test_flash_attention.py, and the error relative to the reference's
# largest value and to its RMS (a typical output is ~0.026 at S=4097).
ABS_TOL, REL_MAX_TOL, REL_RMS_TOL = 3e-2, 2e-2, 1e-2


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernel, no interpret mode)")
    return torch.device("cuda")


def _randn(shape, seed: int, dev, dtype=torch.bfloat16):
    gen = torch.Generator(device=dev).manual_seed(seed)
    return torch.randn(shape, generator=gen, device=dev, dtype=dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("sq,skv", [(200, 200), (4097, 4097), (130, 300)])
def test_kernel_matches_plain_on_card(sq, skv):
    dev = _card()
    q = _randn((1, 4, sq, 64), 1, dev)
    k = _randn((1, 4, skv, 64), 2, dev)
    v = _randn((1, 4, skv, 64), 3, dev)
    for bounded in (False, True):
        before = fa.launches.count
        out = fa.flash_attention(q, k, v, bounded_logits=bounded)
        torch.cuda.synchronize()
        assert fa.launches.count == before + 1
        ref = fa.flash_attention_plain(q, k, v, bounded_logits=bounded)
        assert out.shape == q.shape and out.dtype == torch.bfloat16
        diff, ref = out.float() - ref.float(), ref.float()
        max_abs = float(diff.abs().max())
        assert max_abs <= ABS_TOL
        assert max_abs <= REL_MAX_TOL * float(ref.abs().max())
        assert float(diff.square().mean().sqrt()) <= (
            REL_RMS_TOL * float(ref.square().mean().sqrt()))


@pytest.mark.cuda
def test_wrapper_raises_on_what_the_kernel_does_not_take():
    dev = _card()
    q = _randn((1, 2, 64, 64), 4, dev)
    before = fa.launches.count
    with pytest.raises(ValueError, match="bfloat16"):
        fa.flash_attention(q.float(), q.float(), q.float())
    with pytest.raises(ValueError, match="head_dim"):
        d128 = _randn((1, 2, 64, 128), 5, dev)
        fa.flash_attention(d128, d128, d128)
    with pytest.raises(ValueError, match="contiguous"):
        t = q.transpose(1, 2)
        fa.flash_attention(t, t, t)
    with pytest.raises(NotImplementedError):
        fa.flash_attention(q, q, q, bounded_logits=True, qk_int8=True)
    assert fa.launches.count == before
