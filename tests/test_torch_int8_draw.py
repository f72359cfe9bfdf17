"""ROADMAP C.5: is the int8 VAE modes' drift on the port's draws a fault of
the port's quantizer, or a property of the draw?

The outlier family's worst conv on the card, ``decoder.up.3.res.2.conv2``
(128 -> 128 channels, 24.1% local int8 error in the attribution), drawn at
full width on the CPU with the port's ``realistic_params`` (the VAE of the
drift runs: seed 2, bf16), is quantized on the same calibration activations
(a seeded crop of 3 frames at 16 x 16, SiLU of normals, as the conv's input
after its norm) by the port's ``quantize_conv`` and by the JAX package's
``_quantize_leaf_dict`` as ``quantize_vae`` and the attribution call it:
with the activation amax (equalization, round to nearest: the attribution's
quantizer) and with the tap autocorrelation too (GPTQ rounding: the serving
quantizer of the calibrated modes). The codes, scales, equalization and
ksum are compared, and each package's local int8 error (its causal int8 conv
against the float one on the crop, as the attribution records it).
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dove_tpu.models import vae as jvae
from dove_tpu.ops import quant as jquant
from dove_tpu_torch.int8_weight_floor import synthetic_vae
from dove_tpu_torch.models import vae as tvae
from dove_tpu_torch.ops import quant as tquant
from torch_threads import two_torch_threads  # noqa: F401 (autouse)

CONV = "decoder.up.3.res.2.conv2"
# the two packages' local errors on the same codes: their int8 convs differ
# only in the activation quantizer's and the epilogue's fp32 order
LOCAL_ERR_RTOL = 1e-3


@pytest.fixture(scope="module")
def draw():
    """The conv's holder and its float weights from the port's outlier draw,
    and the crop's calibration statistics."""
    vae = synthetic_vae("cogvideox1.5-5b", "outlier", "cpu")
    (_, _, parent, attr, conv), = [c for c in tquant.quantizable_convs(vae)
                                   if c[0] == CONV]
    rng = np.random.default_rng(5)
    g = rng.standard_normal((1, 128, 3, 16, 16)).astype(np.float32)
    x = torch.from_numpy(g / (1.0 + np.exp(-g))).to(torch.bfloat16)
    amax = x.float().abs().amax(dim=(0, 2, 3, 4))
    tapcorr = tvae._tap_autocorr(x.double()).float()
    return parent, attr, conv, x, amax, tapcorr


def _local_err(y: np.ndarray, y_q: np.ndarray) -> float:
    y, y_q = y.astype(np.float64), y_q.astype(np.float64)
    return float(np.sqrt(np.square(y_q - y).sum() / np.square(y).sum()))


@pytest.mark.parametrize("rounding", ["nearest", "gptq"])
def test_worst_outlier_conv_quantizes_as_jax(draw, rounding):
    parent, attr, conv, x, amax, tapcorr = draw
    tc = tapcorr if rounding == "gptq" else None
    qc = tquant.quantize_conv(conv, with_ksum=True, calib_amax=amax, tapcorr=tc)
    w = conv.weight.detach()  # bf16 [O, I, 3, 3, 3]
    leaf = {"kernel": jnp.asarray(w.float().permute(2, 3, 4, 1, 0).numpy(), jnp.bfloat16),
            "bias": jnp.asarray(conv.bias.detach().float().numpy(), jnp.bfloat16)}
    ref = jquant._quantize_leaf_dict(
        leaf, donate=False, with_ksum=True, calib_amax=jnp.asarray(amax.numpy()),
        tapcorr=None if tc is None else jnp.asarray(tc.numpy()))

    # codes [3, 3, 3, I, O] -> the port's packed [taps, O, I]
    codes = np.asarray(ref["kernel_q"]).reshape(27, 128, 128).transpose(0, 2, 1)
    ours = qc.weight_q.numpy()
    assert ours.shape == codes.shape
    flips = int((ours != codes).sum())
    assert np.abs(ours.astype(int) - codes.astype(int)).max() <= 1
    assert flips <= (0 if rounding == "nearest" else 2e-3 * codes.size), flips
    np.testing.assert_allclose(qc.kernel_scale.numpy(),
                               np.asarray(ref["kernel_scale"]).reshape(-1), rtol=1e-6)
    np.testing.assert_allclose(qc.equalize_inv.numpy(), np.asarray(ref["equalize_inv"]),
                               rtol=1e-6)

    # local int8 error on the crop, each package on its own codes
    with torch.no_grad():
        y = tvae.causal_conv3d(parent, x, None)[0]
        setattr(parent, attr, qc)
        try:
            y_q = tvae.causal_conv3d(parent, x, None)[0]
        finally:
            setattr(parent, attr, conv)
    err = _local_err(y.float().numpy(), y_q.float().numpy())
    xj = jnp.asarray(x.float().permute(0, 2, 3, 4, 1).numpy(), jnp.bfloat16)
    yj = np.asarray(jvae.causal_conv3d(leaf, xj, None)[0], np.float32)
    yj_q = np.asarray(jvae.causal_conv3d(ref, xj, None)[0], np.float32)
    err_j = _local_err(yj, yj_q)
    assert err == pytest.approx(err_j, rel=LOCAL_ERR_RTOL if flips == 0 else 0.05)
    # the same quantizer on the same draw: what is left of the card's 24.1%
    # is the draw's and the clip's activations' (on this crop: ~2.4%)
    assert 0 < err < 0.5
