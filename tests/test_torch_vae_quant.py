"""Parity of the port's int8 VAE (ops/quant.py's VAE half, the quantized and
hand-conv branches of models/vae.py, calibration and attribution) with
dove_tpu.

fp32 on the CPU, inputs from numpy seeds. The JAX functions run under
``jax.jit`` where the JAX package runs them jitted (the quantizers inside a
forward), because XLA compiles a division by a constant into a product with
its reciprocal and the port copies that. Where JAX reaches a Pallas kernel it
runs in interpret mode. The VAEs are the smallest that the >= 64-channel
quantization policy selects from (tests/test_quant.py's), and one of 128
channels, which the CUDA kernel's shapes need.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dove_tpu.ops.pallas.conv3d_int8 as jconv
from dove_tpu import config as jcfg
from dove_tpu.models import vae as jvae
from dove_tpu.ops import quant as jquant
from dove_tpu_torch import config as tcfg
from dove_tpu_torch import weights as tweights
from dove_tpu_torch.models import vae as tvae
from dove_tpu_torch.ops import conv3d_int8 as tconv
from dove_tpu_torch.ops import quant
from torch_threads import two_torch_threads  # noqa: F401 (autouse)

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

ATOL = 1e-4  # fp32 forwards, different summation orders


def _vae_kwargs(chans):
    return dict(latent_channels=8, block_out_channels=chans, layers_per_block=1,
                norm_num_groups=4, sample_frames_batch_size=8,
                latent_frames_batch_size=2, tile_sample_min_height=16,
                tile_sample_min_width=16)


def _make(chans, seed=2):
    """(JAX cfg, JAX tree as numpy, torch cfg, fresh torch VAE maker)."""
    cfg_j = jcfg.VAEConfig(**_vae_kwargs(chans))
    cfg_t = tcfg.VAEConfig(**_vae_kwargs(chans))
    tree = jax.tree.map(np.asarray, jvae.init_vae_params(jax.random.PRNGKey(seed), cfg_j))

    def torch_vae(t=tree):
        return tweights.convert_vae(tweights.jax_vae_to_diffusers(t), cfg_t, torch.float32)

    return cfg_j, tree, cfg_t, torch_vae


@pytest.fixture(scope="module")
def vae64():
    return _make((64, 64))


@pytest.fixture(scope="module")
def vae64x3():
    """Three levels, so that "lowres" leaves something quantized."""
    return _make((64, 64, 64), seed=3)


def _ncdhw(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(x).permute(0, 4, 1, 2, 3)


def _ndhwc(x: torch.Tensor) -> np.ndarray:
    return x.permute(0, 2, 3, 4, 1).numpy()


def _silu_like(rng, shape):
    """Skewed like a SiLU output: bounded below, a long positive tail."""
    return np.maximum(rng.normal(1.0, 2.0, shape), -0.278).astype(np.float32)


# ---------------------------------------------------------------------------
# Activation quantizers
# ---------------------------------------------------------------------------

def test_dynamic_quant_matches_jax():
    x = np.random.default_rng(0).normal(0, 3, (2, 3, 5, 7, 16)).astype(np.float32)
    ref_q, ref_s = jax.jit(jquant.dynamic_quant)(jnp.asarray(x))
    q, s = quant.dynamic_quant(torch.from_numpy(x))
    assert float(s) == float(ref_s)
    np.testing.assert_array_equal(q.numpy(), np.asarray(ref_q))


def _candidate_errors_f64(xs: np.ndarray):
    """The twelve candidates' (s, m) in fp32, as the quantizers make them,
    and their squared errors on ``xs`` in float64."""
    f = np.float32
    amax, amin = f(xs.max()), f(xs.min())
    ct = np.asarray(quant._TAIL_CLIP_CANDIDATES, f)
    cs = np.asarray(quant._SYM_CLIP_CANDIDATES, f)
    a = max(abs(amax), abs(amin))
    lo = np.concatenate([np.ones_like(ct) * amin, -cs * a])
    hi = np.concatenate([amin + ct * (amax - amin), cs * a])
    m_c = f(0.5) * (hi + lo)
    s_c = np.maximum((hi - lo) * f(1.0 / 254.0), f(1e-12))
    x64 = xs.astype(np.float64)
    errs = []
    for s, m in zip(s_c.astype(np.float64), m_c.astype(np.float64)):
        q = np.clip(np.round((x64 - m) / s), -127, 127)
        errs.append(np.sum((q * s + m - x64) ** 2))
    return s_c, m_c, np.asarray(errs)


@pytest.mark.parametrize("with_eq", [False, True])
@pytest.mark.parametrize("shape", [(1, 3, 20, 24, 16),  # 1,440 rows: no subsample
                                   (2, 4, 72, 64, 8)])  # 36,864 rows: 8 segments
def test_dynamic_quant_asym_matches_jax(shape, with_eq):
    rng = np.random.default_rng(sum(shape) + with_eq)
    x = _silu_like(rng, shape)
    eq = np.exp(rng.normal(0, 0.5, shape[-1])).astype(np.float32) if with_eq else None
    fn = jax.jit(lambda a, e: jquant.dynamic_quant_asym(a, eq_inv=e))
    ref_q, ref_s, ref_m = fn(jnp.asarray(x), None if eq is None else jnp.asarray(eq))
    te = None if eq is None else torch.from_numpy(eq)
    q, s, m = quant.dynamic_quant_asym(torch.from_numpy(x), eq_inv=te)
    # the chosen candidate, held where the best two are clearly apart
    sample, _ = quant._search_sample(torch.from_numpy(x), -1)
    xs = sample.numpy() * (eq if with_eq else np.float32(1.0))
    s_c, m_c, errs64 = _candidate_errors_f64(xs)
    best2 = np.sort(errs64)[:2]
    assert (best2[1] - best2[0]) / best2[0] > 1e-3, "a near tie: pick another seed"
    k = int(np.argmin(errs64))
    assert float(s) == float(ref_s) == float(s_c[k])
    assert float(m) == float(ref_m) == float(m_c[k])
    _, _, errs = quant.asym_grid(torch.from_numpy(x), eq_inv=te, return_errors=True)
    np.testing.assert_allclose(errs.numpy(), errs64, rtol=1e-5)
    # with eq_inv too: the port keeps XLA's fused multiply-add (asym_codes)
    np.testing.assert_array_equal(q.numpy(), np.asarray(ref_q))
    # the VAE's layout: channels on axis 1, the same grid and the same codes
    xc = torch.from_numpy(x).permute(0, 4, 1, 2, 3).contiguous()
    qc, sc, mc = quant.dynamic_quant_asym(xc, eq_inv=te, channel_dim=1)
    assert float(sc) == float(s) and float(mc) == float(m)
    assert torch.equal(qc.permute(0, 2, 3, 4, 1), q)


def test_search_sample_is_the_jax_subsample():
    """8 contiguous segments of n_rows // 1024 rows at multiples of n_rows //
    8, whichever axis holds the channels, also across batch items."""
    x = torch.arange(3 * 11000 * 4, dtype=torch.float32).reshape(3, 1, 110, 100, 4)
    n_rows = 33000
    seg, step = n_rows // 1024, n_rows // 8
    want = torch.cat([x.reshape(-1, 4)[i * step:i * step + seg] for i in range(8)])
    last, shape = quant._search_sample(x, -1)
    assert torch.equal(last, want) and shape == (1, 4)
    first, shape = quant._search_sample(x.permute(0, 4, 1, 2, 3).contiguous(), 1)
    assert torch.equal(first.T, want) and shape == (4, 1)


def test_dynamic_quant_asym_without_search_matches_jax():
    rng = np.random.default_rng(5)
    x = _silu_like(rng, (1, 2, 6, 6, 8))
    eq = np.exp(rng.normal(0, 0.5, 8)).astype(np.float32)
    for e in (None, eq):
        fn = jax.jit(lambda a, v: jquant.dynamic_quant_asym(a, tail_clip=False, eq_inv=v))
        _, ref_s, ref_m = fn(jnp.asarray(x), None if e is None else jnp.asarray(e))
        _, s, m = quant.dynamic_quant_asym(
            torch.from_numpy(x), tail_clip=False,
            eq_inv=None if e is None else torch.from_numpy(e))
        assert float(s) == float(ref_s) and float(m) == float(ref_m)


def test_range_search_reads_nothing_back_to_the_host():
    """136 convs a decode, each with a range search: the chosen grid must
    stay on the device. On meta tensors any read of a value (an ``.item()``,
    an index by a 0-d tensor, a Python branch on a tensor) raises."""
    x = torch.empty((1, 8, 3, 200, 200), device="meta")  # above the subsample threshold
    eq = torch.empty(8, device="meta")
    for e in (None, eq):
        s, m = quant.asym_grid(x, eq_inv=e, channel_dim=1)
        assert s.shape == m.shape == () and s.device.type == "meta"
        out = torch.empty((1, 3, 200, 200, 8), dtype=torch.int8, device="meta")
        codes = quant.asym_codes(x, s, m, e, channel_dim=1, out=out.permute(0, 4, 1, 2, 3))
        assert codes.dtype == torch.int8
    q, s = quant.dynamic_quant(x)
    assert q.dtype == torch.int8 and s.shape == ()


# ---------------------------------------------------------------------------
# Weight side
# ---------------------------------------------------------------------------

def _torch_w(w: np.ndarray) -> torch.Tensor:
    """JAX kernel [(kt,) kh, kw, I, O] -> torch [O, I, (kt,) kh, kw]."""
    perm = (4, 3, 0, 1, 2) if w.ndim == 5 else (3, 2, 0, 1)
    return torch.from_numpy(np.ascontiguousarray(w.transpose(perm)))


def test_equalization_vector_matches_jax():
    rng = np.random.default_rng(6)
    w = rng.normal(0, 0.05, (3, 3, 3, 32, 16)).astype(np.float32)
    w[:, :, :, 5] = 0.0  # a dead input channel keeps d = 1
    amax = np.exp(rng.normal(0, 1, 32)).astype(np.float32)
    amax[7] = 0.0
    ref = np.asarray(jquant.equalization_vector(jnp.asarray(w), jnp.asarray(amax)))
    ours = quant.equalization_vector(_torch_w(w), torch.from_numpy(amax)).numpy()
    assert ours[5] == ours[7] == 1.0
    np.testing.assert_allclose(ours, ref, rtol=1e-6)


@pytest.mark.parametrize("kt,padding", [(3, 1), (1, 1), (1, 0)])
def test_ksum_correction_matches_jax(kt, padding):
    rng = np.random.default_rng(7)
    ksum = rng.integers(-8000, 8000, (kt, 3, 3, 1, 16)).astype(np.float32)
    H, W = 7, 5
    pad = ((0, 0), (padding, padding), (padding, padding))
    ref = jquant.ksum_correction(
        {"kernel_ksum": jnp.asarray(ksum)}, (1, kt + 1, H, W, 1), (1, 1, 1), pad,
        ("NDHWC", "DHWIO", "NDHWC"), jnp.float32)
    ours = quant.ksum_correction(
        torch.from_numpy(ksum.reshape(-1, 16).T.reshape(16, 1, kt, 3, 3).copy()),
        H, W, padding)
    want = np.asarray(ref).transpose(0, 4, 1, 2, 3)  # [1, O, 2, Ho, Wo]
    np.testing.assert_array_equal(np.broadcast_to(ours.numpy(), want.shape), want)


def test_ksum_correction_of_thin_inputs():
    ksum = torch.arange(16 * 9, dtype=torch.float32).reshape(16, 1, 1, 3, 3)
    for H, W in ((1, 1), (1, 4), (2, 2), (3, 2)):
        want = torch.nn.functional.conv3d(torch.ones(1, 1, 1, H, W), ksum,
                                          padding=(0, 1, 1))
        assert torch.equal(quant.ksum_correction(ksum, H, W, 1), want)


def test_gptq_tap_rounding_matches_jax():
    """The Cholesky factor of H^-1 comes from two linear-algebra libraries
    and differs in its last bits; 26 steps of error feedback turn that into a
    few flipped codes. Held by: codes equal on >= 99.5% of entries; per
    column, the expected output error delta^T H0 delta within 1e-3 relative
    and the safety net's choice equal, each on >= 99.5% of columns."""
    rng = np.random.default_rng(8)
    w = (rng.standard_t(3, (3, 3, 3, 32, 24)) * 0.03).astype(np.float32)
    scale = (np.abs(w).max(axis=(0, 1, 2, 3)) / 127.0).astype(np.float32)
    x = rng.normal(0, 1, (1, 6, 12, 12, 4)).astype(np.float32)
    x = x + np.roll(x, 1, 2) + np.roll(x, 1, 3) + np.roll(x, 1, 1)  # smooth
    tapcorr = np.asarray(jvae._tap_autocorr(jnp.asarray(x)))
    ours_corr = tvae._tap_autocorr(_ncdhw(x)).numpy()
    np.testing.assert_allclose(ours_corr, tapcorr, rtol=1e-5, atol=1e-6)
    ref = np.asarray(jax.jit(jquant.gptq_tap_rounding)(
        jnp.asarray(w), jnp.asarray(scale), jnp.asarray(tapcorr)))
    ours = quant.gptq_tap_rounding(torch.from_numpy(w), torch.from_numpy(scale),
                                   torch.from_numpy(tapcorr.copy())).numpy()
    assert ours.dtype == np.int8 and ours.shape == w.shape
    assert (ours == ref).mean() >= 0.995
    # the shared Hessian, in float64
    taps = [(a, b, c) for a in range(3) for b in range(3) for c in range(3)]
    H0 = np.array([[tapcorr[ti[0] - tj[0] + 2, ti[1] - tj[1] + 2, ti[2] - tj[2] + 2]
                    for tj in taps] for ti in taps], np.float64)
    w0 = w.reshape(27, 32, 24).astype(np.float64)

    def column_error(codes):
        d = codes.reshape(27, 32, 24) * scale.astype(np.float64) - w0
        return np.einsum("tij,ts,sij->ij", d, H0, d)

    e_ours, e_ref = column_error(ours), column_error(ref)
    close = np.abs(e_ours - e_ref) <= 1e-3 * np.abs(e_ref)
    assert close.mean() >= 0.995
    rtn = np.clip(np.round(w / scale), -127, 127).reshape(27, 32, 24)
    kept_rtn = lambda c: (c.reshape(27, 32, 24) == rtn).all(axis=0)
    assert (kept_rtn(ours) == kept_rtn(ref)).mean() >= 0.995
    assert (~kept_rtn(ours)).mean() > 0.2  # the feedback does win somewhere


def test_quantize_weight_clip_search_matches_jax():
    """The ratios come from two implementations of a geometric progression,
    so the scales are held to 1e-6 relative, the codes to 99.9%."""
    rng = np.random.default_rng(9)
    w = (rng.standard_t(2, (3, 3, 3, 16, 12)) * 0.02).astype(np.float32)
    ref_q, ref_s = jquant._quantize_weight_jit(jnp.asarray(w), 8)
    q, s = quant.quantize_weight(_torch_w(w), clip_search=8)
    np.testing.assert_allclose(s.numpy(), np.asarray(ref_s), rtol=1e-6)
    assert (q.permute(2, 3, 4, 1, 0).numpy() == np.asarray(ref_q)).mean() >= 0.999


# ---------------------------------------------------------------------------
# quantize_vae: which convs, which names, which codes
# ---------------------------------------------------------------------------

def _jax_names(tree, which="all"):
    names = []

    def walk(node, path):
        if isinstance(node, dict):
            if "kernel" in node and jquant.should_quantize_conv(node["kernel"]):
                names.append(jquant.calib_name(path))
                return
            for k, v in node.items():
                walk(v, path + (k,))
        elif isinstance(node, list):
            for i, v in enumerate(node):
                walk(v, path + (i,))

    for half in (("encoder", "decoder") if which == "all" else (which,)):
        walk(tree[half], (half,))
    return sorted(names)


def _state_of_jax_tree(q_tree, cfg_t):
    q_np = jax.tree.map(np.asarray, q_tree)
    return tweights.convert_vae(tweights.jax_vae_to_diffusers(q_np), cfg_t,
                                torch.float32).state_dict()


def test_calib_names_match_jax(vae64x3):
    _, tree, _, torch_vae = vae64x3
    vae = torch_vae()
    ours = sorted(name for name, *_ in quant.quantizable_convs(vae))
    assert ours == _jax_names(tree) and len(ours) == 30
    for path in [("decoder", "up_blocks", 0, "resnets", 1, "conv1"),
                 ("decoder", "mid_block", "resnets", 0, "conv2"),
                 ("encoder", "down_blocks", 2, "downsampler", "conv")]:
        assert quant.calib_name(path) == jquant.calib_name(path)
    assert (quant.module_calib_name("encoder.down_blocks.2.downsamplers.0.conv")
            == "encoder.down.2.downsample")
    assert sorted(quant.synthetic_vae_calib(vae)) == sorted(
        jquant.synthetic_vae_calib(jax.tree.map(jnp.asarray, tree)))
    assert quant.lowres_decoder_exclusions(vae) == jquant.lowres_decoder_exclusions(tree)
    assert len(quant.lowres_decoder_exclusions(vae)) == 9


@pytest.mark.parametrize("which", ["all", "decoder", "encoder"])
def test_quantize_vae_codes_match_jax(vae64x3, which):
    """Without calibration the codes, scales and channel sums are JAX's own."""
    _, tree, cfg_t, torch_vae = vae64x3
    q_tree = jquant.quantize_vae(jax.tree.map(jnp.asarray, tree), donate=False,
                                 which=which)
    want = _state_of_jax_tree(q_tree, cfg_t)
    vae = quant.quantize_vae(torch_vae(), which=which)
    got = vae.state_dict()
    assert sorted(got) == sorted(want)
    n_q = sum(isinstance(m, quant.QConv3d) for m in vae.modules())
    assert n_q == len(_jax_names(tree, which)) == {"all": 30, "decoder": 18, "encoder": 12}[which]
    for key, ref in want.items():
        assert got[key].dtype == ref.dtype and torch.equal(got[key], ref), key


def test_quantize_vae_exclude_and_lowres(vae64x3):
    _, tree, cfg_t, torch_vae = vae64x3
    names = quant.lowres_decoder_exclusions(torch_vae())
    q_tree = jquant.quantize_vae(jax.tree.map(jnp.asarray, tree), donate=False,
                                 which="decoder", exclude=names)
    want = _state_of_jax_tree(q_tree, cfg_t)
    vae = quant.quantize_vae(torch_vae(), which="decoder", exclude=names)
    got = vae.state_dict()
    assert sorted(got) == sorted(want)
    assert all(torch.equal(got[k], want[k]) for k in want)
    assert isinstance(vae.decoder.mid_block.resnets[0].conv1.conv, torch.nn.Conv3d)
    assert isinstance(vae.decoder.up_blocks[1].resnets[0].conv1.conv, quant.QConv3d)
    assert isinstance(vae.decoder.up_blocks[1].upsamplers[0].conv, quant.QConv3d)
    with pytest.raises(ValueError, match="not found among quantizable convs"):
        quant.quantize_vae(torch_vae(), exclude=("decoder.up.9.res.0.conv1",))
    with pytest.raises(ValueError, match="not found among quantizable convs"):
        # an encoder name is unknown to the decoder half, as in JAX
        quant.quantize_vae(torch_vae(), which="decoder",
                           exclude=("encoder.mid.0.conv1",))
    with pytest.raises(ValueError, match="which="):
        quant.quantize_vae(torch_vae(), which="both")


def _calibrations(cfg_j, tree, cfg_t, vae, video, lat):
    jt = jax.tree.map(jnp.asarray, tree)
    _, enc_j = jvae.calibrate(
        lambda v: jvae.encoder_forward(cfg_j, jt["encoder"], v, None), jnp.asarray(video))
    _, dec_j = jvae.calibrate(
        lambda z: jvae.decoder_forward(cfg_j, jt["decoder"], z, None), jnp.asarray(lat))
    _, enc_t = tvae.calibrate(
        lambda v: tvae.encoder_forward(cfg_t, vae.encoder, v, None), _ncdhw(video))
    _, dec_t = tvae.calibrate(
        lambda z: tvae.decoder_forward(cfg_t, vae.decoder, z, None), _ncdhw(lat))
    return {**enc_j, **dec_j}, {**enc_t, **dec_t}


@pytest.fixture(scope="module")
def calibrated(vae64):
    cfg_j, tree, cfg_t, torch_vae = vae64
    rng = np.random.default_rng(11)
    video = rng.uniform(-1, 1, (1, 5, 16, 16, 3)).astype(np.float32)
    lat = rng.standard_normal((1, 2, 8, 8, 8)).astype(np.float32)
    calib_j, calib_t = _calibrations(cfg_j, tree, cfg_t, torch_vae(), video, lat)
    return calib_j, calib_t, video, lat


def test_calibrate_stats_match_jax(vae64, calibrated):
    """Every named conv records under JAX's name; every quantizable conv's
    name is among them (the property tests/test_quant.py:125 guards)."""
    _, _, _, torch_vae = vae64
    calib_j, calib_t, _, _ = calibrated
    assert sorted(calib_t) == sorted(calib_j)
    assert any(k.startswith("encoder.") for k in calib_t)
    assert any(k.endswith("#tapcorr") for k in calib_t)
    for name, *_ in quant.quantizable_convs(torch_vae()):
        assert name in calib_t and f"{name}#tapcorr" in calib_t
    for key, ref in calib_j.items():
        ref = np.asarray(ref)
        np.testing.assert_allclose(calib_t[key].numpy(), ref, rtol=1e-5,
                                   atol=1e-5 * float(np.abs(ref).max()), err_msg=key)


def test_quantize_vae_with_calibration_matches_jax(vae64, calibrated):
    """Equalized, and GPTQ-rounded where a tapcorr is given: the vector d goes
    through pow, log and exp of two libraries, so scales and equalize_inv are
    held to 1e-6 relative and the codes to 99.5% (the GPTQ bar)."""
    _, tree, cfg_t, torch_vae = vae64
    calib_j, _, _, _ = calibrated
    amax_only = {k: v for k, v in calib_j.items() if "#" not in k}
    for calib, bar in ((amax_only, 0.999), (calib_j, 0.995)):
        q_tree = jquant.quantize_vae(jax.tree.map(jnp.asarray, tree), donate=False,
                                     calib=calib)
        want = _state_of_jax_tree(q_tree, cfg_t)
        vae = quant.quantize_vae(
            torch_vae(), calib={k: torch.tensor(np.asarray(v)) for k, v in calib.items()})
        got = vae.state_dict()
        assert sorted(got) == sorted(want)
        assert sum(k.endswith("equalize_inv") for k in got) == 22
        for key, ref in want.items():
            if key.endswith("weight_q"):
                assert (got[key] == ref).float().mean() >= bar, key
                ksum = key.replace("weight_q", "kernel_ksum")
                cout = ref.shape[1]
                assert torch.equal(
                    got[ksum], got[key].float().sum(2).T.reshape(cout, 1, -1, 3, 3))
            elif not key.endswith("kernel_ksum"):
                torch.testing.assert_close(got[key], ref, rtol=1e-6, atol=0, msg=key)


def test_attribute_quant_error_matches_jax(vae64, calibrated):
    cfg_j, tree, cfg_t, torch_vae = vae64
    calib_j, calib_t, _, lat = calibrated
    jt = jax.tree.map(jnp.asarray, tree)
    vae = torch_vae()
    for cj, ct in ((None, None), (calib_j, calib_t)):
        out_j, err_j = jvae.attribute_quant_error(
            lambda z: jvae.decoder_forward(cfg_j, jt["decoder"], z, None)[0],
            jnp.asarray(lat), calib=cj)
        out_t, err_t = tvae.attribute_quant_error(
            lambda z: tvae.decoder_forward(cfg_t, vae.decoder, z, None)[0],
            _ncdhw(lat), calib=ct)
        # the float activations keep flowing: the output is the float one
        np.testing.assert_allclose(_ndhwc(out_t), np.asarray(out_j), atol=ATOL)
        assert sorted(err_t) == sorted(err_j) and len(err_t) == 13
        for key, (e2, n2) in err_j.items():
            # 2e-3: the error sum is made of roundings, a few of which fall
            # the other way when the conv's input differs in its last bits
            np.testing.assert_allclose(float(err_t[key][0]), float(e2), rtol=2e-3, err_msg=key)
            np.testing.assert_allclose(float(err_t[key][1]), float(n2), rtol=1e-5, err_msg=key)
            assert 0 < float(err_t[key][0]) < 1e-2 * float(err_t[key][1])


# ---------------------------------------------------------------------------
# Quantized convs and forwards
# ---------------------------------------------------------------------------

def _qconv_of_leaf(leaf) -> quant.QConv3d:
    """A JAX quantized conv leaf carried into a QConv3d: the same codes."""
    state: dict = {}
    tweights._quantized_conv_leaves(jax.tree.map(np.asarray, leaf), "", state)
    t = {k: torch.from_numpy(v) for k, v in state.items()}
    return quant.QConv3d(t["weight_q"], t["kernel_scale"], t.get("kernel_ksum"),
                         t.get("equalize_inv"), t.get("bias"))


def _conv_pair(rng, kt, cin, cout, calib: bool):
    """A JAX quantized leaf and the port's QConv3d of the same float conv.

    Without calibration the port quantizes the conv itself and gets JAX's
    codes. With it, the equalization vector goes through pow, log and exp of
    two libraries and differs in its last bits, which moves the grid and
    flips a code here and there: the port's own quantization is then held to
    JAX's at 1e-6 relative and 99.9% of the codes, and the JAX leaf is
    carried across for the forward, so that both sides run the same codes."""
    shape = (kt, 3, 3, cin, cout) if kt else (3, 3, cin, cout)
    w = rng.normal(0, 0.05, shape).astype(np.float32)
    b = rng.normal(0, 0.1, cout).astype(np.float32)
    amax = (np.exp(rng.normal(0, 0.7, cin)).astype(np.float32) if calib else None)
    leaf = jquant._quantize_leaf_dict(
        {"kernel": jnp.asarray(w), "bias": jnp.asarray(b)}, donate=False,
        with_ksum=True, calib_amax=None if amax is None else jnp.asarray(amax))
    conv = (torch.nn.Conv3d(cin, cout, (kt, 3, 3)) if kt else torch.nn.Conv2d(cin, cout, 3))
    with torch.no_grad():
        conv.weight.copy_(_torch_w(w))
        conv.bias.copy_(torch.from_numpy(b))
    qc = quant.quantize_conv(conv, with_ksum=True,
                             calib_amax=None if amax is None else torch.from_numpy(amax))
    carried = _qconv_of_leaf(leaf)
    if not calib:
        assert all(torch.equal(v, carried.state_dict()[k]) for k, v in qc.state_dict().items())
        return leaf, qc
    torch.testing.assert_close(qc.equalize_inv, carried.equalize_inv, rtol=1e-6, atol=0)
    torch.testing.assert_close(qc.kernel_scale, carried.kernel_scale, rtol=1e-6, atol=0)
    assert (qc.weight_q == carried.weight_q).float().mean() >= 0.999
    return leaf, carried


@pytest.mark.parametrize("calib", [False, True])
def test_quantized_causal_conv3d_matches_jax(calib):
    """Cache threading included: a clip start and a continuation."""
    rng = np.random.default_rng(12 + calib)
    leaf, qc = _conv_pair(rng, 3, 64, 64, calib)
    x = _silu_like(rng, (2, 5, 9, 8, 64))
    fn = jax.jit(lambda a, c: jvae.causal_conv3d(leaf, a, c))
    ref0, cache = fn(jnp.asarray(x[:, :3]), None)
    ref1, _ = fn(jnp.asarray(x[:, 3:]), cache)
    ours0, tcache = tvae.causal_conv3d(qc, _ncdhw(x[:, :3]), None)
    ours1, _ = tvae.causal_conv3d(qc, _ncdhw(x[:, 3:]), tcache)
    np.testing.assert_allclose(_ndhwc(ours0), np.asarray(ref0), atol=ATOL)
    np.testing.assert_allclose(_ndhwc(ours1), np.asarray(ref1), atol=ATOL)
    assert ours0.is_contiguous() and ours0.dtype == torch.float32


@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("calib", [False, True])
def test_quantized_per_frame_conv_matches_jax(stride, calib):
    """The upsampler's conv (stride 1, padding 1) and the downsampler's
    (stride 2 after its (0, 1) pad), through _upsample and _downsample."""
    rng = np.random.default_rng(20 + stride + 2 * calib)
    leaf, qc = _conv_pair(rng, 0, 64, 64, calib)
    holder = tvae.Conv2dHolder(64)
    holder.conv = qc
    x = _silu_like(rng, (1, 3, 6, 7, 64))
    if stride == 1:
        ref = jax.jit(lambda a: jvae._upsample({"conv": leaf}, a, True))(jnp.asarray(x))
        ours = tvae._upsample(holder, _ncdhw(x), True)
    else:
        ref = jax.jit(lambda a: jvae._downsample({"conv": leaf}, a, True))(jnp.asarray(x))
        ours = tvae._downsample(holder, _ncdhw(x), True)
    assert _ndhwc(ours).shape == ref.shape
    np.testing.assert_allclose(_ndhwc(ours), np.asarray(ref), atol=ATOL)


def test_symmetric_qconv_matches_jax():
    """A leaf quantized without kernel_ksum takes symmetric activations."""
    rng = np.random.default_rng(30)
    w = rng.normal(0, 0.05, (3, 3, 3, 64, 64)).astype(np.float32)
    amax = np.exp(rng.normal(0, 0.7, 64)).astype(np.float32)
    leaf = jquant._quantize_leaf_dict({"kernel": jnp.asarray(w)}, donate=False,
                                      calib_amax=jnp.asarray(amax))
    conv = torch.nn.Conv3d(64, 64, 3, bias=False)
    with torch.no_grad():
        conv.weight.copy_(_torch_w(w))
    own = quant.quantize_conv(conv, calib_amax=torch.from_numpy(amax))
    assert own.kernel_ksum is None and own.bias is None
    qc = _qconv_of_leaf(leaf)  # the same codes on both sides (see _conv_pair)
    assert qc.kernel_ksum is None and qc.bias is None
    assert (own.weight_q == qc.weight_q).float().mean() >= 0.999
    x = rng.normal(0, 1, (1, 4, 6, 6, 64)).astype(np.float32)
    ref, _ = jax.jit(lambda a: jvae.causal_conv3d(leaf, a, None))(jnp.asarray(x))
    ours, _ = tvae.causal_conv3d(qc, _ncdhw(x), None)
    np.testing.assert_allclose(_ndhwc(ours), np.asarray(ref), atol=ATOL)


def test_qconv_border_is_exactly_zero():
    """The padded border holds the code 0, and the ksum term turns it into
    real 0: a quantized conv of a constant image equals the dequantized
    operands' zero-padded float conv, borders included."""
    torch.manual_seed(0)
    conv = torch.nn.Conv3d(64, 64, 3)
    qc = quant.quantize_conv(conv, with_ksum=True)
    x = torch.full((1, 64, 3, 6, 6), 0.7)
    x[0, :, :, 2, 3] = -0.2  # a range, so that the grid is not degenerate
    s, m = quant.asym_grid(x, channel_dim=1)
    x_deq = quant.asym_codes(x, s, m, channel_dim=1).float() * s + m
    w_deq = (qc.weight_q.float() * qc.kernel_scale[None, :, None]).reshape(
        3, 3, 3, 64, 64).permute(3, 4, 0, 1, 2)
    want = torch.nn.functional.conv3d(x_deq, w_deq, qc.bias, padding=(0, 1, 1))
    got = quant.qconv(qc, x)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


def test_qconv_rejects_other_geometries():
    qc = quant.quantize_conv(torch.nn.Conv3d(64, 64, 3), with_ksum=True)
    with pytest.raises(ValueError, match="stride"):
        quant.qconv(qc, torch.zeros(1, 64, 3, 4, 4), stride=2, padding=1)
    with pytest.raises(ValueError, match="channels"):
        quant.qconv(qc, torch.zeros(1, 32, 3, 4, 4))


def _rms(a) -> float:
    return float(np.sqrt(np.mean(np.square(np.asarray(a, np.float64)))))


def _jax_forward_refs(fn_q, fn_float, x: np.ndarray, seed: int) -> tuple:
    """JAX's quantized forward of ``x`` and of ``x`` moved by 1e-6 and 1e-5
    (seeded), and its float forward: what the parity below holds the port
    to."""
    ref = np.asarray(fn_q(jnp.asarray(x)))
    flt = np.asarray(fn_float(jnp.asarray(x)))
    rng = np.random.default_rng(seed)
    moved = [np.asarray(fn_q(jnp.asarray(x + rng.normal(0, eps, x.shape).astype(np.float32))))
             for eps in (1e-6, 1e-5)]
    return ref, flt, moved


def _assert_quantized_forward_parity(fn_q, fn_float, ours: np.ndarray, x: np.ndarray, seed: int):
    _assert_parity_with(_jax_forward_refs(fn_q, fn_float, x, seed), ours)


def _assert_parity_with(refs: tuple, ours: np.ndarray) -> None:
    """A forward through several quantized convs is ill-conditioned, in JAX
    as in the port: each conv's range search makes a discrete choice and
    each code a rounding, so an input moved by 1e-6 moves JAX's own output by
    about a hundredth of its rms (and two frameworks' GroupNorms already
    differ by that much after one layer). No elementwise tolerance holds
    between them. What does hold, and is asserted: the port is as close to
    JAX as JAX is to itself under perturbations of 1e-6 to 1e-5 (times 1.25),
    and it sits as far from the float model as JAX's own runs do (within 10%
    of their range). The
    single-conv tests above hold the arithmetic itself to 1e-4."""
    ref, flt, moved = refs
    own = max(_rms(m - ref) for m in moved)
    assert ours.shape == ref.shape
    assert _rms(ours - ref) <= 1.25 * own, (_rms(ours - ref), own)
    drifts = [_rms(m - flt) for m in (ref, *moved)]
    drift_ref, drift_ours = drifts[0], _rms(ours - flt)
    assert 0.9 * min(drifts) <= drift_ours <= 1.1 * max(drifts), (drift_ours, drifts)
    assert drift_ref < 0.05 * _rms(flt)  # int8 stays near the float model


def _forward_inputs() -> tuple[np.ndarray, np.ndarray]:
    rng = np.random.default_rng(13)
    video = rng.uniform(-1, 1, (1, 5, 16, 16, 3)).astype(np.float32)
    lat = rng.standard_normal((1, 2, 8, 8, 8)).astype(np.float32)
    return video, lat


@pytest.fixture(scope="module")
def decoder_refs(vae64):
    """JAX's decode of _forward_inputs' latent through its quantized decoder
    (which="decoder"; "all" quantizes the decoder the same way), moved and
    float: computed once for both cases of the test below."""
    cfg_j, tree, _, _ = vae64
    jt = jax.tree.map(jnp.asarray, tree)
    q_tree = jquant.quantize_vae(jt, donate=False, which="decoder")
    return q_tree["decoder"], _jax_forward_refs(
        jax.jit(lambda z: jvae.decode(cfg_j, q_tree, z)),
        jax.jit(lambda z: jvae.decode(cfg_j, jt, z)), _forward_inputs()[1], 2)


@pytest.mark.parametrize("which", ["all", "decoder"])
def test_quantized_vae_forwards_match_jax(vae64, decoder_refs, which):
    """Encode and decode of the quantized VAE, one frame chunk each (the
    chunked forms run in tests/test_torch_int8_pipeline.py), each
    side quantizing its own copy of the same float weights (the codes are
    equal: test_quantize_vae_codes_match_jax). With ``which="decoder"`` the
    encoder is the float one and matches elementwise. Both cases decode with
    the same quantized decoder (asserted), so JAX's decodes are shared."""
    cfg_j, tree, cfg_t, torch_vae = vae64
    video, lat = _forward_inputs()
    jt = jax.tree.map(jnp.asarray, tree)
    q_tree = jquant.quantize_vae(jt, donate=False, which=which)
    dec_tree, dec_refs = decoder_refs
    for a, b in zip(jax.tree.leaves(q_tree["decoder"]), jax.tree.leaves(dec_tree)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    vae = quant.quantize_vae(torch_vae(), which=which)
    enc_q = jax.jit(lambda v: jvae.encode_moments(cfg_j, q_tree, v))
    with torch.no_grad():
        ours_m = tvae.encode_moments(cfg_t, vae, torch.from_numpy(video)).numpy()
        ours_p = tvae.decode(cfg_t, vae, torch.from_numpy(lat)).numpy()
    if which == "all":
        _assert_quantized_forward_parity(
            enc_q, jax.jit(lambda v: jvae.encode_moments(cfg_j, jt, v)), ours_m, video, 1)
    else:
        np.testing.assert_allclose(ours_m, np.asarray(enc_q(jnp.asarray(video))), atol=ATOL)
    _assert_parity_with(dec_refs, ours_p)


def test_from_jax_params_takes_a_quantized_vae_tree(vae64, calibrated):
    """The JAX-quantized tree (equalized: every leaf kind) carried across:
    the same buffers, and the same decode."""
    cfg_j, tree, cfg_t, _ = vae64
    calib_j, _, _, lat = calibrated
    amax_only = {k: v for k, v in calib_j.items() if "#" not in k}
    q_tree = jquant.quantize_vae(jax.tree.map(jnp.asarray, tree), donate=False,
                                 calib=amax_only)
    cfg = tcfg.PipelineConfig(dit=tcfg.tiny_test().dit, vae=cfg_t)
    dit_tree = jax.tree.map(np.asarray, __import__(
        "dove_tpu.models.dit", fromlist=["x"]).init_dit_params(
            jax.random.PRNGKey(0), jcfg.tiny_test().dit))
    _, vae = tweights.from_jax_params(cfg, dit_tree, jax.tree.map(np.asarray, q_tree))
    leaf = q_tree["decoder"]["up_blocks"][0]["upsampler"]["conv"]
    mod = vae.decoder.up_blocks[0].upsamplers[0].conv
    assert isinstance(mod, quant.QConv3d) and mod.kt == 1
    codes = np.asarray(leaf["kernel_q"])  # [3, 3, I, O]
    np.testing.assert_array_equal(mod.weight_q[5].numpy(), codes[1, 2].T)
    np.testing.assert_array_equal(mod.kernel_ksum[:, 0, 0].numpy(),
                                  np.asarray(leaf["kernel_ksum"])[:, :, 0].transpose(2, 0, 1))
    np.testing.assert_array_equal(mod.equalize_inv.numpy(), np.asarray(leaf["equalize_inv"]))
    mid = vae.decoder.mid_block.resnets[0].conv1.conv
    assert isinstance(mid, quant.QConv3d) and mid.kt == 3 and mid.weight_q.shape == (27, 64, 64)
    # buffers that must stay fp32 do, whatever the model is cast to
    half = vae.to(torch.bfloat16)
    assert half.decoder.mid_block.resnets[0].conv1.conv.kernel_scale.dtype == torch.float32
    assert half.decoder.mid_block.resnets[0].conv1.conv.bias.dtype == torch.bfloat16
    vae = vae.to(torch.float32)
    jt = jax.tree.map(jnp.asarray, tree)
    with torch.no_grad():
        ours = tvae.decode(cfg_t, vae, torch.from_numpy(lat)).numpy()
    _assert_quantized_forward_parity(
        jax.jit(lambda z: jvae.decode(cfg_j, q_tree, z)),
        jax.jit(lambda z: jvae.decode(cfg_j, jt, z)), ours, lat, 3)


def test_vae_wide_enough_for_the_cuda_kernel():
    """128 channels: every quantized conv has shapes K4 takes on the card,
    and the decode still matches JAX."""
    cfg_j, tree, cfg_t, torch_vae = _make((128, 128), seed=4)
    q_tree = jquant.quantize_vae(jax.tree.map(jnp.asarray, tree), donate=False,
                                 which="decoder")
    vae = quant.quantize_vae(torch_vae(), which="decoder")
    qconvs = [m for m in vae.modules() if isinstance(m, quant.QConv3d)]
    assert len(qconvs) == 13
    assert all(tconv.kernel_supports(m.in_channels, m.out_channels) for m in qconvs)
    lat = np.random.default_rng(14).standard_normal((1, 2, 4, 4, 8)).astype(np.float32)
    jt = jax.tree.map(jnp.asarray, tree)
    with torch.no_grad():
        ours = tvae.decode(cfg_t, vae, torch.from_numpy(lat)).numpy()
    _assert_quantized_forward_parity(
        jax.jit(lambda z: jvae.decode(cfg_j, q_tree, z)),
        jax.jit(lambda z: jvae.decode(cfg_j, jt, z)), ours, lat, 4)


# ---------------------------------------------------------------------------
# K5's route
# ---------------------------------------------------------------------------

def test_hand_conv_route_matches_jax(monkeypatch):
    """set_pallas_conv routes an eligible float conv through K5 (its plain
    version here, the Pallas kernel in interpret mode there), cache threading
    included; an ineligible conv and the switched-off state keep the library
    convolution."""
    monkeypatch.setattr(jconv.pl, "pallas_call",
                        functools.partial(jconv.pl.pallas_call, interpret=True))
    jconv.conv3d_bf16.clear_cache()
    rng = np.random.default_rng(7)
    x = rng.normal(0, 1, (1, 5, 10, 21, 128)).astype(np.float32)
    w = rng.normal(0, 0.03, (3, 3, 3, 128, 128)).astype(np.float32)
    b = rng.normal(0, 0.1, 128).astype(np.float32)
    p = {"kernel": jnp.asarray(w), "bias": jnp.asarray(b)}
    conv = torch.nn.Conv3d(128, 128, 3).requires_grad_(False)
    conv.weight.copy_(_torch_w(w))
    conv.bias.copy_(torch.from_numpy(b))
    plain, _ = tvae.causal_conv3d(conv, _ncdhw(x), None)
    calls = []
    real = tconv.conv_taps
    monkeypatch.setattr(tconv, "conv_taps", lambda *a, **k: calls.append(1) or real(*a, **k))
    jvae.set_pallas_conv(True)
    tvae.set_pallas_conv(True)
    try:
        ref, ref_cache = jvae.causal_conv3d(p, jnp.asarray(x), None)
        ours, cache = tvae.causal_conv3d(conv, _ncdhw(x), None)
        assert calls == [1]
        small = torch.nn.Conv3d(64, 64, 3)  # not a multiple of 128: cuDNN's route
        tvae.causal_conv3d(small, torch.zeros(1, 64, 2, 4, 4), None)
        assert calls == [1]
    finally:
        jvae.set_pallas_conv(False)
        tvae.set_pallas_conv(False)
    np.testing.assert_array_equal(_ndhwc(cache), np.asarray(ref_cache))
    # both round the operands to bf16 and sum 3456 products in fp32
    np.testing.assert_allclose(_ndhwc(ours), np.asarray(ref),
                               atol=2e-5 * float(np.abs(np.asarray(ref)).max()))
    # against the float conv: bf16 operand rounding (tests/test_conv_kernel.py)
    np.testing.assert_allclose(ours.numpy(), plain.numpy(), atol=0.02, rtol=0.02)
    tvae.causal_conv3d(conv, _ncdhw(x), None)
    assert calls == [1]  # switched off again
