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
from dove_tpu_torch.ops import quant

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
    with pytest.raises(NotImplementedError):  # K2 is inference only
        fa.flash_attention(q, q, q, bounded_logits=True, qk_int8=True, with_lse=True)
    with pytest.raises(ValueError, match="requires bounded_logits"):
        fa.flash_attention(q, q, q, qk_int8=True)
    with pytest.raises(ValueError, match="bfloat16"):  # K2 takes bf16 too
        fa.flash_attention(q.float(), q.float(), q.float(), bounded_logits=True,
                           qk_int8=True)
    assert fa.launches.count == before


def _assert_within_bars(out: torch.Tensor, ref: torch.Tensor) -> None:
    diff, ref = out.float() - ref.float(), ref.float()
    max_abs = float(diff.abs().max())
    assert max_abs <= ABS_TOL
    assert max_abs <= REL_MAX_TOL * float(ref.abs().max())
    assert float(diff.square().mean().sqrt()) <= (
        REL_RMS_TOL * float(ref.square().mean().sqrt()))


# K1's logsumexp against its plain version: fp32 on both sides from the same
# bf16 inputs, differing in summation order and in ex2.approx.
LSE_TOL = 1e-3


@pytest.mark.cuda
@pytest.mark.parametrize("sq,skv", [(200, 200), (130, 300)])
@pytest.mark.parametrize("bounded", [False, True])
def test_k1_lse_and_k3_match_plain_on_card(sq, skv, bounded):
    """K1's training form (output and logsumexp), then K3a and K3b on the
    same inputs, against their plain versions at K1's bars; each kernel
    counts one launch."""
    dev = _card()
    q = _randn((2, 3, sq, 64), 11, dev)
    k = _randn((2, 3, skv, 64), 12, dev)
    v = _randn((2, 3, skv, 64), 13, dev)
    do = _randn((2, 3, sq, 64), 14, dev)
    counters = (fa.launches, fa.launches_lse, fa.launches_bwd_dq, fa.launches_bwd_dkv)
    before = [c.count for c in counters]
    out, lse = fa.flash_attention(q, k, v, bounded_logits=bounded, with_lse=True)
    ref, ref_lse = fa.flash_attention_plain(q, k, v, bounded_logits=bounded,
                                            with_lse=True)
    _assert_within_bars(out, ref)
    assert lse.shape == (2, 3, sq) and lse.dtype == torch.float32
    assert float((lse - ref_lse).abs().max()) <= LSE_TOL
    delta = (do.float() * out.float()).sum(-1)
    dq = fa.flash_bwd_dq_launch(q, k, v, do, lse, delta, 0.125)
    dk, dv = fa.flash_bwd_dkv_launch(q, k, v, do, lse, delta, 0.125)
    torch.cuda.synchronize()
    assert [c.count - b for c, b in zip(counters, before)] == [0, 1, 1, 1]
    ref_dq = fa.flash_bwd_dq_plain(q, k, v, do, lse, delta, 0.125)
    ref_dk, ref_dv = fa.flash_bwd_dkv_plain(q, k, v, do, lse, delta, 0.125)
    for got, want in ((dq, ref_dq), (dk, ref_dk), (dv, ref_dv)):
        assert got.dtype == torch.bfloat16 and got.shape == want.shape
        _assert_within_bars(got, want)


@pytest.mark.cuda
def test_flash_autograd_on_card_matches_plain_autograd():
    """Gradients through FlashAttention on the card (K1 with lse, K3a, K3b)
    against the same function on the plain versions (backend "plain")."""
    from dove_tpu_torch.ops import attention as tattn

    dev = _card()
    q, k, v = (_randn((1, 4, 333, 64), s, dev).requires_grad_() for s in (15, 16, 17))
    g = _randn((1, 4, 333, 64), 18, dev)
    grads = {}
    for backend in ("flash", "plain"):
        out = tattn.full_attention(q, k, v, backend=backend)
        grads[backend] = torch.autograd.grad(out, (q, k, v), g)
    for got, want in zip(grads["flash"], grads["plain"]):
        _assert_within_bars(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("sq,skv", [(200, 200), (4097, 4097), (130, 300), (1, 77)])
def test_k2_matches_plain_on_card(sq, skv):
    """K2 on bf16 inputs against its plain version on the same int8 codes,
    at K1's bars; each call adds one to K2's counter and none to K1's."""
    dev = _card()
    q = _randn((1, 4, sq, 64), 6, dev)
    k = _randn((1, 4, skv, 64), 7, dev)
    v = _randn((1, 4, skv, 64), 8, dev)
    before, before_k1 = fa.launches_qk8.count, fa.launches.count
    out = fa.flash_attention(q, k, v, bounded_logits=True, qk_int8=True)
    torch.cuda.synchronize()
    assert fa.launches_qk8.count == before + 1 and fa.launches.count == before_k1
    q8, k8, factor = fa.quantize_qk_pair(q, k, 64 ** -0.5)
    ref = fa.flash_attention_qk8_plain(q8, k8, v, factor)
    assert out.shape == q.shape and out.dtype == torch.bfloat16
    diff, ref = out.float() - ref.float(), ref.float()
    max_abs = float(diff.abs().max())
    assert max_abs <= ABS_TOL
    assert max_abs <= REL_MAX_TOL * float(ref.abs().max())
    assert float(diff.square().mean().sqrt()) <= (
        REL_RMS_TOL * float(ref.square().mean().sqrt()))


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [5, 333])
def test_qlinear_on_card_matches_cpu(rows):
    """QLinear on the card (torch._int_mm, padded below 17 rows) against the
    same module on the CPU: equal int8 codes, exactly equal int32
    accumulators, and outputs equal to fp32 rounding of the epilogue."""
    dev = _card()
    lin = torch.nn.Linear(72, 40)
    mod = quant.QLinear.from_linear(lin)
    x = torch.randn(2, rows, 72)
    x_q, s_x = quant.dynamic_quant_rows(x.reshape(-1, 72))
    x_q_card, s_x_card = quant.dynamic_quant_rows(x.reshape(-1, 72).to(dev))
    assert torch.equal(x_q_card.cpu(), x_q) and torch.equal(s_x_card.cpu(), s_x)
    acc = quant.int8_matmul(x_q, mod.weight_q)
    acc_card = quant.int8_matmul(x_q_card, mod.weight_q.to(dev))
    assert torch.equal(acc_card.cpu(), acc)
    torch.testing.assert_close(mod.to(dev)(x.to(dev)).cpu(), mod.cpu()(x),
                               rtol=1e-6, atol=1e-6)
