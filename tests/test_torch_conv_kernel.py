"""Parity of the port's tap convolution (K4 and K5, ops/conv3d_int8.py) with
dove_tpu's Pallas conv kernels.

The JAX side runs its kernels in interpret mode on the CPU, as
tests/test_conv_kernel.py does; the port's side is the plain version, which
is what the CUDA kernel is held to on the card (tests/test_torch_cuda.py,
chip_smoke.py). K4 is exact (int32 sums, one fp32 multiply, one rounding), so
the comparison is for equality; K5 sums fp32 products in another order, so
it is held to 2e-5 of the largest output, the bar of tests/test_conv_kernel.py.
"""

from __future__ import annotations

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

import dove_tpu.ops.pallas.conv3d_int8 as conv_mod
from dove_tpu_torch.ops import conv3d_int8 as tconv


@pytest.fixture(autouse=True)
def _interpret(monkeypatch):
    monkeypatch.setattr(
        conv_mod.pl, "pallas_call",
        functools.partial(conv_mod.pl.pallas_call, interpret=True),
    )
    # the jit cache would otherwise reuse a non-interpret trace
    conv_mod.conv3d_w8a8.clear_cache()
    conv_mod.conv3d_bf16.clear_cache()


SHAPES = [
    (5, 12, 38, 128, 128),  # the Pallas kernel's width-padding path
    (4, 7, 20, 256, 128),  # several cin blocks
    (3, 34, 11, 128, 256),  # several cout blocks and row blocks
]


def _int8_case(shape, seed):
    Fr, Hp, Wp, Cin, Cout = shape
    rng = np.random.default_rng(seed)
    x_q = rng.integers(-127, 128, (Fr, Hp, Wp, Cin)).astype(np.int8)
    w_q = rng.integers(-127, 128, (3, 3, 3, Cin, Cout)).astype(np.int8)
    sk = (rng.random(Cout, np.float32) * 0.02).astype(np.float32)
    return x_q, w_q, np.float32(0.013), sk


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("out", ["bfloat16", "float32"])
def test_conv3d_w8a8_plain_equals_pallas(shape, out):
    x_q, w_q, sx, sk = _int8_case(shape, sum(shape))
    ref = conv_mod.conv3d_w8a8(jnp.asarray(x_q), jnp.asarray(w_q), jnp.float32(sx),
                               jnp.asarray(sk), out_dtype=getattr(jnp, out))
    ours = tconv.conv3d_w8a8(torch.from_numpy(x_q), torch.from_numpy(w_q),
                             torch.tensor(sx), torch.from_numpy(sk),
                             out_dtype=getattr(torch, out))
    assert ours.shape == ref.shape == (shape[0] - 2, shape[1] - 2, shape[2] - 2, shape[4])
    assert ours.dtype == getattr(torch, out)
    np.testing.assert_array_equal(ours.float().numpy(), np.asarray(ref, np.float32))


@pytest.mark.parametrize("shape", [s[:1] + (min(s[1], 18),) + s[2:] for s in SHAPES])
def test_conv3d_bf16_plain_matches_pallas(shape):
    Fr, Hp, Wp, Cin, Cout = shape
    rng = np.random.default_rng(sum(shape))
    x = rng.normal(0, 1, (Fr, Hp, Wp, Cin)).astype(np.float32)
    w = rng.normal(0, 0.03, (3, 3, 3, Cin, Cout)).astype(np.float32)
    ref = np.asarray(conv_mod.conv3d_bf16(
        jnp.asarray(x, jnp.bfloat16), jnp.asarray(w, jnp.bfloat16),
        out_dtype=jnp.float32))
    # fp32 operands are rounded to bf16 inside, as the JAX function does
    ours = tconv.conv3d_bf16(torch.from_numpy(x), torch.from_numpy(w),
                             out_dtype=torch.float32).numpy()
    assert ours.shape == ref.shape
    np.testing.assert_allclose(ours, ref, atol=2e-5 * float(np.abs(ref).max()), rtol=0)
    bf = tconv.conv3d_bf16(torch.from_numpy(x), torch.from_numpy(w))
    assert bf.dtype == torch.bfloat16
    np.testing.assert_allclose(bf.float().numpy(), ref, atol=0.02, rtol=0.02)


@pytest.mark.parametrize("kt", [1, 3])
@pytest.mark.parametrize("channels_first", [False, True])
def test_conv_taps_batch_kt_and_layout(kt, channels_first):
    """The form the VAE calls: a batch, k_t = 3 or 1, NCDHW out if asked;
    against a float64 convolution of the same integers, which is exact."""
    rng = np.random.default_rng(10 + kt)
    B, Fo, Ho, Wo, Cin, Cout = 2, 2, 5, 7, 64, 128
    x_q = rng.integers(-127, 128, (B, Fo + kt - 1, Ho + 2, Wo + 2, Cin)).astype(np.int8)
    w_q = rng.integers(-127, 128, (kt, 3, 3, Cin, Cout)).astype(np.int8)
    scale = (rng.random(Cout) * 0.01).astype(np.float32)
    packed = tconv.pack_taps(torch.from_numpy(w_q if kt == 3 else w_q[0]))
    assert packed.shape == (kt * 9, Cout, Cin) and packed.is_contiguous()
    np.testing.assert_array_equal(packed[4].numpy(), w_q[0, 1, 1].T)
    ours = tconv.conv_taps(torch.from_numpy(x_q), packed, torch.from_numpy(scale),
                           kt, torch.float32, channels_first)
    acc = F.conv3d(torch.from_numpy(x_q).double().permute(0, 4, 1, 2, 3),
                   torch.from_numpy(w_q).double().permute(4, 3, 0, 1, 2))
    want = (acc.float() * torch.from_numpy(scale).view(1, -1, 1, 1, 1))
    if not channels_first:
        want = want.permute(0, 2, 3, 4, 1)
    assert ours.shape == want.shape
    assert torch.equal(ours, want)
    assert tconv.launches_w8a8.count == tconv.launches_w8a8_kt1.count == 0


def test_a_skipped_tap_is_seen():
    """The check that the comparisons on the card can fail: the plain
    version with one tap left out differs from the whole one."""
    x_q, w_q, sx, sk = _int8_case((3, 6, 6, 64, 128), 3)
    args = (torch.from_numpy(x_q)[None], tconv.pack_taps(torch.from_numpy(w_q)),
            torch.from_numpy(sk) * float(sx))
    whole = tconv.conv_taps_plain(*args, 3, torch.float32)
    short = tconv.conv_taps_plain(*args, 3, torch.float32, skip_tap=13)
    assert not torch.equal(whole, short)


def test_wrong_inputs_raise():
    x = torch.zeros((1, 3, 4, 4, 64), dtype=torch.int8)
    w = torch.zeros((27, 128, 64), dtype=torch.int8)
    scale = torch.ones(128)
    with pytest.raises(ValueError, match="does not go with"):
        tconv.conv_taps(x, w[:9], scale, 3)
    with pytest.raises(ValueError, match="causal cache frames"):
        tconv.conv_taps(x[:, :2], w, scale, 3)
    with pytest.raises(ValueError, match="int8 x goes with"):
        tconv.conv_taps(x, w, None, 3)
    with pytest.raises(ValueError, match="run on cuda"):
        tconv.conv_taps_launch(x, w, scale, 3)
    with pytest.raises(ValueError, match="weights"):
        tconv.pack_taps(torch.zeros((3, 5, 5, 8, 8)))
    assert tconv.kernel_supports(128, 256) and not tconv.kernel_supports(64, 64)
