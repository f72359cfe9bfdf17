"""K1's logsumexp and K3a/K3b in the PyTorch port against dove_tpu's kernels.

On the CPU the port's training attention runs the plain versions: the
logsumexp of :func:`flash_attention_plain`, the backward of
:func:`flash_attention_bwd_plain`, and the ``FlashAttention`` autograd
function around them. They are held to ``dove_tpu``'s Pallas kernels run in
interpret mode (as tests/test_flash_attention.py runs them), with 128-blocks
so that the JAX side pads and masks ragged tiles: ``_flash_fwd(...,
with_lse=True)`` for the logsumexp and ``jax.vjp`` of ``flash_attention``,
which runs ``_bwd_dq_kernel`` and ``_bwd_dkv_kernel``, for the gradients.
The CUDA kernels are held to the same plain versions on the card by
chip_smoke.py and tests/test_torch_cuda.py.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dove_tpu.ops.pallas.flash_attention import _flash_fwd
from dove_tpu.ops.pallas.flash_attention import flash_attention as jax_flash
from dove_tpu_torch.ops import attention as tattn
from dove_tpu_torch.ops import flash_attention as fa

# fp32 on both sides; they differ in summation order (over up to 640 keys
# and queries, with values of order 1)
ATOL = 1e-4
SHAPES = [(200, 200), (640, 640), (130, 300)]


def _inputs(sq: int, skv: int, seed: int, H: int = 2, D: int = 64):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((1, H, sq, D)).astype(np.float32)
    k = rng.standard_normal((1, H, skv, D)).astype(np.float32)
    v = rng.standard_normal((1, H, skv, D)).astype(np.float32)
    g = rng.standard_normal((1, H, sq, D)).astype(np.float32)
    return q, k, v, g


@pytest.mark.parametrize("sq,skv", SHAPES)
@pytest.mark.parametrize("bounded", [False, True])
def test_lse_matches_pallas_interpret(sq, skv, bounded):
    q, k, v, _ = _inputs(sq, skv, seed=sq + skv + bounded)
    H = q.shape[1]
    out_j, lse_j = _flash_fwd(
        jnp.asarray(q[0]), jnp.asarray(k[0]), jnp.asarray(v[0]), 0.125, 128, 128,
        with_lse=True, bounded=bounded)
    fa.launches.reset()
    fa.launches_lse.reset()
    out, lse = fa.flash_attention(*(torch.from_numpy(x) for x in (q, k, v)),
                                  bounded_logits=bounded, with_lse=True)
    assert lse.shape == (1, H, sq) and lse.dtype == torch.float32
    np.testing.assert_allclose(lse[0].numpy(), np.asarray(lse_j), atol=ATOL, rtol=0)
    np.testing.assert_allclose(out[0].numpy(), np.asarray(out_j), atol=ATOL, rtol=0)
    assert fa.launches.count == 0 and fa.launches_lse.count == 0


def _jax_grads(q, k, v, g, bounded):
    def f(q_, k_, v_):
        return jax_flash(q_, k_, v_, None, 128, 128, bounded, False)

    out, vjp = jax.vjp(f, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    return np.asarray(out), [np.asarray(x) for x in vjp(jnp.asarray(g))]


@pytest.mark.parametrize("sq,skv", SHAPES)
@pytest.mark.parametrize("bounded", [False, True])
def test_backward_matches_pallas_interpret(sq, skv, bounded):
    """The plain K3a/K3b and the FlashAttention autograd function (through
    flash_attention and through the "plain" backend) against jax.vjp of the
    TPU kernels."""
    q, k, v, g = _inputs(sq, skv, seed=10 + sq + skv + bounded)
    out_j, grads_j = _jax_grads(q, k, v, g, bounded)

    qt, kt, vt, gt = (torch.from_numpy(x) for x in (q, k, v, g))
    out, lse = fa.flash_attention_plain(qt, kt, vt, 0.125, bounded, with_lse=True)
    plain = fa.flash_attention_bwd_plain(qt, kt, vt, out, lse, gt, 0.125)
    for ours, ref in zip(plain, grads_j):
        np.testing.assert_allclose(ours.numpy(), ref, atol=ATOL, rtol=0)

    counters = (fa.launches, fa.launches_lse, fa.launches_bwd_dq, fa.launches_bwd_dkv)
    for c in counters:
        c.reset()
    for route in ("flash", "plain"):
        leaves = [x.clone().requires_grad_() for x in (qt, kt, vt)]
        if route == "flash":
            o = fa.flash_attention(*leaves, bounded_logits=bounded)
        else:
            o = tattn.full_attention(*leaves, backend="plain", bounded_logits=bounded)
        np.testing.assert_allclose(o.detach().numpy(), out_j, atol=ATOL, rtol=0)
        grads = torch.autograd.grad(o, leaves, gt)
        for ours, ref in zip(grads, grads_j):
            assert ours.shape == ref.shape
            np.testing.assert_allclose(ours.numpy(), ref, atol=ATOL, rtol=0)
    assert all(c.count == 0 for c in counters)  # the CPU launches nothing


def test_backward_cast_points_in_bf16():
    """In bf16 the plain backward rounds where K3a and K3b do: ds and p^T to
    bf16 before their products, fp32 sums, outputs in the inputs' dtype."""
    q, k, v, g = (torch.from_numpy(x).to(torch.bfloat16) for x in _inputs(70, 90, 5))
    out, lse = fa.flash_attention_plain(q, k, v, with_lse=True)
    dq, dk, dv = fa.flash_attention_bwd_plain(q, k, v, out, lse, g, 0.125)
    assert (dq.dtype, dk.dtype, dv.dtype) == (torch.bfloat16,) * 3
    delta = (g.float() * out.float()).sum(-1)
    p = torch.exp(q[0, 0].float() @ k[0, 0].float().T * 0.125 - lse[0, 0, :, None])
    want_dv = (p.T.to(torch.bfloat16).float() @ g[0, 0].float()).to(torch.bfloat16)
    ds = p * (g[0, 0].float() @ v[0, 0].float().T - delta[0, 0, :, None]) * 0.125
    want_dq = (ds.to(torch.bfloat16).float() @ k[0, 0].float()).to(torch.bfloat16)
    torch.testing.assert_close(dv[0, 0], want_dv, atol=1e-2, rtol=1e-2)
    torch.testing.assert_close(dq[0, 0], want_dq, atol=1e-2, rtol=1e-2)


def test_qk8_has_no_backward():
    """K2 is inference only: with grad (or a logsumexp) it raises, as the
    JAX package's custom VJP does."""
    q, k, v, _ = (torch.from_numpy(x) for x in _inputs(16, 16, 3))
    leaf = q.clone().requires_grad_()
    with pytest.raises(NotImplementedError):
        fa.flash_attention(leaf, k, v, bounded_logits=True, qk_int8=True)
    with pytest.raises(NotImplementedError):
        tattn.full_attention(leaf, k, v, backend="flash-qk8", bounded_logits=True)
    with torch.no_grad():  # the same call serves without gradients
        assert fa.flash_attention(leaf, k, v, bounded_logits=True,
                                  qk_int8=True).shape == q.shape
