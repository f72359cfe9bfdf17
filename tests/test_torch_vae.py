"""Parity of the PyTorch port's VAE (dove_tpu_torch.models.vae) with dove_tpu.

fp32 on the CPU, TF32 off. The clips are long enough that ``_frame_chunks``
makes two chunks on both sides, so the causal conv cache is threaded; the
causal padding and odd-first-frame rules are also held one primitive at a
time.
"""

from __future__ import annotations

import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dove_tpu import config as jcfg
from dove_tpu.models import vae as jvae
from dove_tpu_torch import config as tcfg
from dove_tpu_torch import weights as tweights
from dove_tpu_torch.models import vae as tvae
from torch_threads import two_torch_threads  # noqa: F401 (autouse)

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

GOLDEN = Path(__file__).resolve().parent / "fixtures" / "golden" / "15"
ATOL = 1e-4  # fp32, different conv summation orders
PSNR_BAR_DB = 50.0  # the bar of tests/test_parity_golden.py


def psnr_db(ours: np.ndarray, ref: np.ndarray) -> float:
    """PSNR over the reference's value range (parity_check.compare's)."""
    ours, ref = np.asarray(ours, np.float64), np.asarray(ref, np.float64)
    span = float(ref.max() - ref.min()) or 1.0
    mse = float(np.mean((ours - ref) ** 2))
    return 200.0 if mse == 0 else 10.0 * np.log10(span**2 / mse)


@pytest.fixture(scope="module")
def tiny_vaes():
    cfg_j = jcfg.tiny_test()
    rng = np.random.default_rng(0)
    tree = jax.tree.map(np.asarray,
                        jvae.init_vae_params(jax.random.PRNGKey(1), cfg_j.vae))
    # move GroupNorm gains/biases off 1/0 so the affine path is exercised
    tree = jax.tree.map(
        lambda x: x + 0.05 * rng.standard_normal(x.shape).astype(np.float32), tree)
    vae = tweights.convert_vae(tweights.jax_vae_to_diffusers(tree),
                               tcfg.tiny_test().vae, torch.float32)
    return cfg_j, jax.tree.map(jnp.asarray, tree), vae


def test_frame_chunks_thread_the_cache():
    # the clip sizes below must really make two chunks
    assert len(tvae._frame_chunks(17, 8)) == 2
    assert len(tvae._frame_chunks(5, 2)) == 2
    for n, b in [(17, 8), (9, 8), (5, 2), (3, 2), (1, 2), (33, 16)]:
        assert tvae._frame_chunks(n, b) == jvae._frame_chunks(n, b)


def test_encode_moments_matches_jax(tiny_vaes):
    cfg_j, tree, vae = tiny_vaes
    video = np.random.default_rng(1).uniform(-1, 1, (1, 17, 32, 24, 3)).astype(np.float32)
    ref = jvae.encode_moments(cfg_j.vae, tree, jnp.asarray(video))
    with torch.no_grad():
        ours = tvae.encode_moments(tcfg.tiny_test().vae, vae, torch.from_numpy(video))
    assert ours.shape == ref.shape == (1, 5, 4, 3, 16)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=ATOL, rtol=0)


def test_decode_matches_jax(tiny_vaes):
    cfg_j, tree, vae = tiny_vaes
    latent = np.random.default_rng(2).standard_normal((1, 5, 4, 3, 8)).astype(np.float32)
    ref = jvae.decode(cfg_j.vae, tree, jnp.asarray(latent))
    with torch.no_grad():
        ours = tvae.decode(tcfg.tiny_test().vae, vae, torch.from_numpy(latent))
    assert ours.shape == ref.shape == (1, 17, 32, 24, 3)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=ATOL, rtol=0)


def test_sample_latent_mean_matches_jax():
    moments = np.random.default_rng(3).standard_normal((1, 3, 4, 4, 16)).astype(np.float32)
    ref = jvae.sample_latent(jnp.asarray(moments), None, 0.7)
    ours = tvae.sample_latent(torch.from_numpy(moments), None, 0.7)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=1e-6, rtol=0)


def _conv3d_pair(rng, kt, cin=3, cout=4):
    w = rng.standard_normal((kt, 3, 3, cin, cout)).astype(np.float32) * 0.3
    b = rng.standard_normal((cout,)).astype(np.float32)
    mod = tvae.CausalConv3d(cin, cout, (kt, 3, 3))
    with torch.no_grad():
        mod.conv.weight.copy_(torch.from_numpy(w.transpose(4, 3, 0, 1, 2).copy()))
        mod.conv.bias.copy_(torch.from_numpy(b))
    return {"kernel": jnp.asarray(w), "bias": jnp.asarray(b)}, mod


def _ncdhw(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(x).permute(0, 4, 1, 2, 3)


def _ndhwc(x: torch.Tensor) -> np.ndarray:
    return x.permute(0, 2, 3, 4, 1).numpy()


def test_causal_conv3d_first_frame_replicate_and_cache():
    """At a clip start the first frame is replicated k_t-1 times as left
    padding; a continuation takes the previous chunk's trailing frames."""
    rng = np.random.default_rng(4)
    p, mod = _conv3d_pair(rng, kt=3)
    x = rng.standard_normal((1, 5, 6, 5, 3)).astype(np.float32)
    ref0, cache0 = jvae.causal_conv3d(p, jnp.asarray(x[:, :3]), None)
    ref1, _ = jvae.causal_conv3d(p, jnp.asarray(x[:, 3:]), cache0)
    with torch.no_grad():
        ours0, tcache = tvae.causal_conv3d(mod, _ncdhw(x[:, :3]), None)
        ours1, _ = tvae.causal_conv3d(mod, _ncdhw(x[:, 3:]), tcache)
        whole, _ = tvae.causal_conv3d(mod, _ncdhw(x), None)
    np.testing.assert_allclose(_ndhwc(ours0), np.asarray(ref0), atol=1e-5)
    np.testing.assert_allclose(_ndhwc(ours1), np.asarray(ref1), atol=1e-5)
    np.testing.assert_allclose(_ndhwc(tcache), np.asarray(cache0), atol=0)
    # chunked == whole clip
    np.testing.assert_allclose(
        torch.cat([ours0, ours1], dim=2).numpy(), whole.numpy(), atol=1e-5)


@pytest.mark.parametrize("frames", [1, 2, 3, 5])
def test_downsample_odd_first_frame(frames):
    rng = np.random.default_rng(10 + frames)
    w = rng.standard_normal((3, 3, 4, 4)).astype(np.float32) * 0.3
    b = rng.standard_normal((4,)).astype(np.float32)
    mod = tvae.Conv2dHolder(4)
    with torch.no_grad():
        mod.conv.weight.copy_(torch.from_numpy(w.transpose(3, 2, 0, 1).copy()))
        mod.conv.bias.copy_(torch.from_numpy(b))
    x = rng.standard_normal((1, frames, 6, 6, 4)).astype(np.float32)
    ref = jvae._downsample({"conv": {"kernel": jnp.asarray(w), "bias": jnp.asarray(b)}},
                           jnp.asarray(x), True)
    with torch.no_grad():
        ours = tvae._downsample(mod, _ncdhw(x), True)
    assert _ndhwc(ours).shape == ref.shape
    np.testing.assert_allclose(_ndhwc(ours), np.asarray(ref), atol=1e-5)


@pytest.mark.parametrize("frames,first", [(1, True), (2, True), (3, True),
                                          (3, False), (1, False)])
def test_upsample_odd_first_frame(frames, first):
    rng = np.random.default_rng(20 + frames)
    w = rng.standard_normal((3, 3, 4, 4)).astype(np.float32) * 0.3
    b = rng.standard_normal((4,)).astype(np.float32)
    mod = tvae.Conv2dHolder(4)
    with torch.no_grad():
        mod.conv.weight.copy_(torch.from_numpy(w.transpose(3, 2, 0, 1).copy()))
        mod.conv.bias.copy_(torch.from_numpy(b))
    x = rng.standard_normal((1, frames, 3, 4, 4)).astype(np.float32)
    ref = jvae._upsample({"conv": {"kernel": jnp.asarray(w), "bias": jnp.asarray(b)}},
                         jnp.asarray(x), True, first)
    with torch.no_grad():
        ours = tvae._upsample(mod, _ncdhw(x), True, first)
    assert _ndhwc(ours).shape == ref.shape
    np.testing.assert_allclose(_ndhwc(ours), np.asarray(ref), atol=1e-5)


@pytest.fixture(scope="module")
def golden_vae():
    from safetensors import safe_open

    fx = np.load(GOLDEN / "golden.npz", allow_pickle=False)
    with safe_open(str(GOLDEN / "vae.safetensors"), framework="pt") as f:
        tensors = {k: f.get_tensor(k) for k in f.keys()}
    cfg = tcfg.tiny_test()
    return cfg, fx, tweights.convert_vae(tensors, cfg.vae, torch.float32)


def test_vae_golden_moments(golden_vae):
    cfg, fx, vae = golden_vae
    with torch.no_grad():
        out = tvae.encode_moments(cfg.vae, vae, torch.from_numpy(fx["input_video"]))
    assert out.shape == fx["vae_moments"].shape
    assert psnr_db(out.numpy(), fx["vae_moments"]) >= PSNR_BAR_DB


def test_vae_golden_decode(golden_vae):
    cfg, fx, vae = golden_vae
    with torch.no_grad():
        out = tvae.decode(cfg.vae, vae, torch.from_numpy(fx["input_latent"]))
    assert out.shape == fx["vae_decode_out"].shape
    assert psnr_db(out.numpy(), fx["vae_decode_out"]) >= PSNR_BAR_DB


# --- the card's route, channels-last, and the routes that keep NCDHW ----------
# The card's route takes CUDA tensors only; here it runs on the CPU with the
# route forced on and the GroupNorm kernel's plain channels-last version in
# the kernel's place, so its layout logic, left frames and caches are held
# to the NCDHW chain.
LAYOUT_CFG = tcfg.VAEConfig(block_out_channels=(8, 16, 16, 16), norm_num_groups=4)


def _card_route_on_cpu(mp: pytest.MonkeyPatch) -> None:
    """The card's route forced on for CPU tensors: the GroupNorm kernel's
    plain version in its place, and convolutions that hand back a
    channels-last input's output channels-last, as cuDNN does."""
    from dove_tpu_torch.ops import group_norm as tgn

    conv3d = torch.nn.functional.conv3d

    def conv3d_like_cudnn(x, *a, **kw):
        y = conv3d(x, *a, **kw)
        return y.contiguous(memory_format=torch.channels_last_3d) if tgn.channels_last(x) else y

    mp.setattr(tvae, "_on_card", lambda x, *m, zq=None: not torch.is_grad_enabled())
    mp.setattr(tgn, "group_norm_silu_launch", tgn.group_norm_silu)
    mp.setattr(torch.nn.functional, "conv3d", conv3d_like_cudnn)


def _two_chunks(fn, first_in: torch.Tensor, second_in: torch.Tensor):
    with torch.no_grad():
        a, cache = fn(first_in, None)
        b, cache2 = fn(second_in, cache)
    return a, b, cache, cache2


def _layout_inputs():
    gen = torch.Generator().manual_seed(21)
    video = torch.rand((1, 3, 13, 16, 24), generator=gen) * 2 - 1  # 9 + 4 frames
    z = torch.randn((1, 16, 5, 2, 3), generator=gen)  # 3 + 2 latent frames
    return video, z


def test_card_route_equals_the_ncdhw_route_over_two_chunks():
    """encoder_forward and decoder_forward on the card's route (channels-last
    activations, the norm writing each causal conv's left frames in place)
    equal the NCDHW chain within fp32 tolerance over two cache-threaded
    chunks, and so does every conv cache they hand on."""
    vae = tvae.init_vae_params(LAYOUT_CFG, seed=5)
    video, z = _layout_inputs()
    enc = lambda x, c: tvae.encoder_forward(LAYOUT_CFG, vae.encoder, x, c)  # noqa: E731
    dec = lambda x, c: tvae.decoder_forward(LAYOUT_CFG, vae.decoder, x, c)  # noqa: E731
    cases = ((enc, video[:, :, :9], video[:, :, 9:]), (dec, z[:, :, :3], z[:, :, 3:]))
    want = [_two_chunks(*c) for c in cases]
    mp = pytest.MonkeyPatch()
    _card_route_on_cpu(mp)
    try:
        got = [_two_chunks(fn, a.contiguous(memory_format=torch.channels_last_3d), b)
               for fn, a, b in cases]
    finally:
        mp.undo()
    for (a, b, c1, c2), (ra, rb, rc1, rc2) in zip(got, want):
        for ours, ref in ((a, ra), (b, rb)):
            assert ours.shape == ref.shape
            assert float((ours - ref).abs().max()) <= 1e-4 * float(ref.abs().max())
        for ours, ref in ((c1, rc1), (c2, rc2)):
            assert ours.keys() == ref.keys()
            for k in ref:
                if ref[k] is None:
                    assert ours[k] is None
                    continue
                scale = float(ref[k].abs().max()) or 1.0
                assert float((ours[k] - ref[k]).abs().max()) <= 1e-4 * scale, k


def test_card_route_reads_channels_last_and_concatenates_no_causal_frames():
    """On the card's route every F.conv3d gets a channels-last input, and no
    causal conv's left frames are concatenated: conv_in's are copied in front
    once, every other causal conv reads what the norm wrote."""
    vae = tvae.init_vae_params(LAYOUT_CFG, seed=6)
    video, z = _layout_inputs()
    seen = {"conv": [], "cat": []}
    mp = pytest.MonkeyPatch()
    _card_route_on_cpu(mp)
    conv3d, cat = torch.nn.functional.conv3d, torch.cat

    def hook_conv(x, *a, **kw):
        seen["conv"].append(x.is_contiguous(memory_format=torch.channels_last_3d)
                            and not x.is_contiguous())
        return conv3d(x, *a, **kw)

    def hook_cat(*a, **kw):
        seen["cat"].append(sys._getframe(1).f_code.co_name)
        return cat(*a, **kw)

    mp.setattr(torch.nn.functional, "conv3d", hook_conv)
    mp.setattr(torch, "cat", hook_cat)
    try:
        _two_chunks(lambda x, c: tvae.encoder_forward(LAYOUT_CFG, vae.encoder, x, c),
                    video[:, :, :9], video[:, :, 9:])
        _two_chunks(lambda x, c: tvae.decoder_forward(LAYOUT_CFG, vae.decoder, x, c),
                    z[:, :, :3], z[:, :, 3:])
    finally:
        mp.undo()
    assert seen["conv"] and all(seen["conv"])
    assert set(seen["cat"]) <= {"_downsample"}  # the odd-length temporal pools only


def _ncdhw_chain(mp: pytest.MonkeyPatch) -> None:
    """The VAE's NCDHW primitives as they were before the card's route went
    channels-last: the nearest resize by three repeat_interleave, the causal
    upsampler's head and rest concatenated, the pool by reshape and mean,
    and each norm's output concatenated with its conv's left frames inside
    causal_conv3d."""

    def nearest(x, f, h, w):
        _, _, Fr, H, W = x.shape
        if f != Fr:
            x = x.repeat_interleave(f // Fr, dim=2)
        if h != H:
            x = x.repeat_interleave(h // H, dim=3)
        if w != W:
            x = x.repeat_interleave(w // W, dim=4)
        return x

    def nearest_causal(z, f, h, w, first=True):
        if first and f > 1 and f % 2 == 1:
            return cat_([nearest(z[:, :, :1], 1, h, w), nearest(z[:, :, 1:], f - 1, h, w)])
        return nearest(z, f, h, w)

    def cat_(parts):
        return torch.cat(parts, dim=2)

    def upsample(p, x, compress_time, first=True, name=None):
        _, _, Fr, H, W = x.shape
        if compress_time and first and Fr > 1 and Fr % 2 == 1:
            x = cat_([nearest(x[:, :, :1], 1, H * 2, W * 2),
                      nearest(x[:, :, 1:], (Fr - 1) * 2, H * 2, W * 2)])
        elif compress_time:
            x = nearest(x, Fr * 2 if Fr > 1 or not first else 1, H * 2, W * 2)
        else:
            x = nearest(x, Fr, H * 2, W * 2)
        return tvae._conv_per_frame(p, x, stride=1, padding=1, name=name)

    def downsample(p, x, compress_time, name=None):
        if compress_time:
            B, C, Fr, H, W = x.shape
            if Fr % 2 == 1:
                first, rest = x[:, :, :1], x[:, :, 1:]
                if rest.shape[2] > 0:
                    rest = rest.reshape(B, C, rest.shape[2] // 2, 2, H, W).mean(dim=3)
                x = cat_([first, rest])
            else:
                x = x.reshape(B, C, Fr // 2, 2, H, W).mean(dim=3)
        x = torch.nn.functional.pad(x, (0, 1, 0, 1))
        return tvae._conv_per_frame(p, x, stride=2, padding=0, name=name)

    def norm_conv(pn, pc, x, zq, first, cache, new_cache, key, keep_cache):
        h = tvae._norm_silu(pn, x, zq, first)
        y, new_cache[key] = tvae.causal_conv3d(pc, h, cache.get(key), keep_cache, name=key)
        return y

    for name, fn in (("_nearest_resize_causal", nearest_causal), ("_upsample", upsample),
                     ("_downsample", downsample), ("_norm_conv", norm_conv)):
        mp.setattr(tvae, name, fn)


WIDE_CFG = tcfg.VAEConfig(latent_channels=8, block_out_channels=(128, 128), layers_per_block=1,
                          norm_num_groups=4, sample_frames_batch_size=8,
                          latent_frames_batch_size=2)


@pytest.mark.parametrize("route", ["int8", "hand_conv", "grad"])
def test_ncdhw_routes_keep_their_results_bit_for_bit(route):
    """The routes that keep NCDHW (the int8 VAE convs, K5's route, a decode
    with gradients; all on the CPU here) give what the NCDHW chain gave
    before the card's route went channels-last, bit for bit: outputs, and
    the gradient for the decode that takes one."""
    from dove_tpu_torch.ops import quant

    vae = tvae.init_vae_params(WIDE_CFG, seed=7)
    if route == "int8":
        vae = quant.quantize_vae(vae, which="all")
    gen = torch.Generator().manual_seed(8)
    video = torch.rand((1, 5, 8, 12, 3), generator=gen) * 2 - 1
    lat = torch.randn((1, 2, 4, 6, 8), generator=gen)

    def run():
        if route == "grad":
            z = lat.clone().requires_grad_(True)
            px = tvae.decode(WIDE_CFG, vae, z, remat=True)
            px.square().sum().backward()
            return px.detach(), z.grad
        with torch.no_grad():
            return (tvae.encode_moments(WIDE_CFG, vae, video),
                    tvae.decode(WIDE_CFG, vae, lat))

    tvae.set_pallas_conv(route == "hand_conv")
    try:
        now = run()
        mp = pytest.MonkeyPatch()
        _ncdhw_chain(mp)
        try:
            before = run()
        finally:
            mp.undo()
    finally:
        tvae.set_pallas_conv(False)
    for a, b in zip(now, before):
        assert torch.equal(a, b)


def test_weights_the_card_route_converted_serve_a_decode_with_gradients():
    """The card's route converts each float conv's weight to channels-last
    in place, under inference mode too; the same VAE then decodes with
    gradients as a fresh one does, bit for bit."""
    vae, fresh = (tvae.init_vae_params(LAYOUT_CFG, seed=9) for _ in range(2))
    _, z = _layout_inputs()
    mp = pytest.MonkeyPatch()
    _card_route_on_cpu(mp)
    try:
        with torch.inference_mode():
            tvae.decoder_forward(LAYOUT_CFG, vae.decoder, z[:, :, :3], None)
    finally:
        mp.undo()
    w = vae.decoder.conv_in.conv.weight
    assert w.is_contiguous(memory_format=torch.channels_last_3d) and not w.is_contiguous()
    grads = []
    for m in (vae, fresh):
        zz = z[:, :, :3].clone().requires_grad_(True)
        px, _ = tvae.decoder_forward(LAYOUT_CFG, m.decoder, zz, None)
        px.square().sum().backward()
        grads.append((px.detach(), zz.grad))
    for a, b in zip(*grads):
        assert torch.equal(a, b)
