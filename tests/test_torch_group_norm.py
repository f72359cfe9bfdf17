"""The VAE's norm primitive on the CPU (``models/vae.py`` ``_norm_silu``, and
``ops/group_norm.py`` around the card's kernel pair).

On a CPU tensor, and for an input that needs a gradient, the primitive is
the plain chain the VAE always ran, bit for bit; every norm site is counted
(29 an encoder pass and 37 a decoder pass at the published structure), none
as fused. The wrapper's host side is checked here too: the nearest-index
rule it gives the kernel equals the VAE's resize, its float32 plain version
equals the VAE's functions in float64, and the chunk plan fills the card.
The kernel itself is tested on the card (``tests/test_torch_cuda.py``).
"""

from __future__ import annotations

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from dove_tpu_torch import config as tcfg
from dove_tpu_torch import obs
from dove_tpu_torch.config import VAEConfig
from dove_tpu_torch.models import vae as tvae
from dove_tpu_torch.ops import group_norm as tgn
from torch_threads import two_torch_threads  # noqa: F401 (autouse)

# the published structure (4 levels, 3 resnets a level) at small widths
CFG = VAEConfig(block_out_channels=(8, 8, 8, 8), norm_num_groups=4)


def _spatial_norm(dtype=torch.float32, seed: int = 0) -> tvae.SpatialNorm3d:
    gen = torch.Generator().manual_seed(seed)
    p = tvae.SpatialNorm3d(8, 16, 4, 1e-6, dtype=dtype)
    with torch.no_grad():
        for t in p.parameters():
            t.copy_(torch.rand(t.shape, generator=gen, dtype=torch.float32) + 0.5)
    return p.requires_grad_(False)  # frozen, as the VAE's modules are


def _x(shape, dtype=torch.float32, seed: int = 1) -> torch.Tensor:
    gen = torch.Generator().manual_seed(seed)
    return (torch.randn(shape, generator=gen) * 2 + 3).to(dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("frames,latent,first", [
    (9, 3, True), (9, 3, False), (8, 2, True), (5, 3, True), (1, 1, True), (4, 4, False),
])
def test_norm_silu_on_the_cpu_is_the_plain_chain(frames, latent, first, dtype):
    """Bit for bit what the VAE computed before the kernel: the spatial norm
    (odd and even frame counts, a clip's first segment and a continuation)
    and the encoder's plain GroupNorm, each followed by SiLU."""
    p = _spatial_norm(dtype)
    x = _x((2, 8, frames, 8, 12), dtype)
    zq = _x((2, 16, latent, 2, 3), dtype, seed=2)
    with torch.no_grad(), obs.unit("cpu") as u:
        got = tvae._norm_silu(p, x, zq, first)
        got_enc = tvae._norm_silu(p.norm_layer, x)
    assert torch.equal(got, F.silu(tvae._spatial_norm3d(p, x, zq, first)))
    assert torch.equal(got_enc, F.silu(tvae._group_norm(p.norm_layer, x)))
    assert u.times == {"vae.norm_n": 2}


def test_norm_silu_with_a_gradient_is_the_plain_chain():
    """An input that needs a gradient (stage 2's decode) keeps the plain
    chain, and its gradient flows; the kernel is not asked for."""
    p = _spatial_norm()
    x = _x((1, 8, 9, 8, 12)).requires_grad_(True)
    zq = _x((1, 16, 3, 2, 3), seed=2)
    before = tgn.launches.count
    out = tvae._norm_silu(p, x, zq, True)
    assert torch.equal(out, F.silu(tvae._spatial_norm3d(p, x, zq, True)))
    out.square().sum().backward()
    assert x.grad is not None and bool(torch.isfinite(x.grad).all())
    assert tgn.launches.count == before


@pytest.mark.parametrize("chunks", [1, 2])
def test_every_norm_site_is_counted_on_the_cpu_route(chunks):
    """29 norm sites an encoder pass (3 resnets x 2 norms x 4 levels, the mid
    block's 4, norm_out) and 37 a decoder pass (4 + 4 resnets x 2 norms x 4
    levels + norm_out), each frame chunk a pass; none fused off the card."""
    vae = tvae.init_vae_params(CFG, seed=1)
    video = _x((1, 9 if chunks == 1 else 17, 16, 16, 3)).clamp(-1, 1)
    with torch.no_grad(), obs.unit("cpu") as enc:
        moments = tvae.encode_moments(CFG, vae, video, chunk_frames=8 if chunks > 1 else None)
    latent = moments[..., :16]
    with torch.no_grad(), obs.unit("cpu") as dec:
        tvae.decode(CFG, vae, latent, chunk_frames=2 if chunks > 1 else None)
    assert enc.times == {"vae.norm_n": 29 * chunks}
    assert dec.times == {"vae.norm_n": 37 * chunks}


def test_a_staged_clip_counts_its_windows_norm_sites():
    """A tiny staged clip: every encoder and decoder pass of every window
    counts its norm sites (13 and 21 at the tiny preset's one resnet a
    level), the whole clip's under ``vae.norm_n``, none fused."""
    from dove_tpu_torch.models.dit import init_dit_params
    from dove_tpu_torch.pipeline import DovePipeline

    cfg = tcfg.tiny_test()
    prompt = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (7, cfg.dit.text_embed_dim)).astype(np.float32))
    pipe = DovePipeline(config=cfg, dit=init_dit_params(cfg.dit, 0),
                        vae=tvae.init_vae_params(cfg.vae, 1), prompt_embedding=prompt,
                        dtype=torch.float32, device="cpu", output_uint8=True,
                        vae_tiling=True)
    calls = {"enc": 0, "dec": 0}
    enc_fwd, dec_fwd = tvae.encoder_forward, tvae.decoder_forward

    def counted(kind, fn):
        def wrapped(*a, **kw):
            calls[kind] += 1
            return fn(*a, **kw)
        return wrapped

    mp = pytest.MonkeyPatch()
    mp.setattr(tvae, "encoder_forward", counted("enc", enc_fwd))
    mp.setattr(tvae, "decoder_forward", counted("dec", dec_fwd))
    try:
        frames = np.random.default_rng(5).uniform(0, 1, (5, 16, 144, 3)).astype(np.float32)
        pipe.process_frames(frames, seed=0)
    finally:
        mp.undo()
    times = pipe.stage_times
    assert calls["enc"] >= times["enc.windows_n"] and calls["dec"] >= times["dec.windows_n"]
    assert times["vae.norm_n"] == 13 * calls["enc"] + 21 * calls["dec"]
    assert "vae.norm_fused_n" not in times


@pytest.mark.parametrize("first", [True, False])
@pytest.mark.parametrize("frames,latent", [(9, 3), (33, 9), (17, 9), (8, 2), (4, 4), (1, 1),
                                           (9, 9), (5, 2)])
def test_modulation_index_is_the_vaes_nearest_resize(frames, latent, first):
    """The latent frame, row and column the kernel reads for each of x's is
    the one ``_nearest_resize_causal`` copies there; where the resize
    refuses the shapes, the ratios refuse them too."""
    lat = torch.arange(latent * 3 * 5, dtype=torch.float64).view(1, 1, latent, 3, 5)
    try:
        want = tvae._nearest_resize_causal(lat, frames, 6, 20, first)
    except (ValueError, ZeroDivisionError, RuntimeError):
        with pytest.raises(ValueError, match="non-integer"):
            tgn.modulation_ratios(frames, 6, 20, (latent, 3, 5), first)
        return
    fi, hi, wi = tgn.modulation_index(frames, 6, 20, (latent, 3, 5), first)
    assert torch.equal(lat[:, :, fi][:, :, :, hi][:, :, :, :, wi], want)


def test_modulation_ratios_refuse_what_the_vae_would():
    with pytest.raises(ValueError, match="non-integer"):
        tgn.modulation_ratios(9, 8, 12, (3, 3, 3), True)  # 8 rows from 3
    with pytest.raises(ValueError, match="non-integer"):
        tgn.modulation_ratios(9, 8, 12, (2, 2, 3), False)  # 9 frames from 2


@pytest.mark.parametrize("first", [True, False])
@pytest.mark.parametrize("with_mod", [True, False])
def test_plain_version_is_the_vaes_function_in_float32(with_mod, first):
    """The kernel's reference: float32 statistics, affine, modulation and
    SiLU, against the VAE's own functions in float64."""
    p = _spatial_norm(torch.float64, seed=3)
    x = _x((2, 8, 9, 8, 12), torch.float64)
    zq = _x((2, 16, 3, 2, 3), torch.float64, seed=2)
    cy, _ = tvae.causal_conv3d(p.conv_y, zq, None)
    cb, _ = tvae.causal_conv3d(p.conv_b, zq, None)
    norm = p.norm_layer
    if with_mod:
        want = F.silu(tvae._spatial_norm3d(p, x, zq, first))
        got = tgn.group_norm_silu(x, 4, norm.weight, norm.bias, norm.eps, cy, cb, first)
    else:
        want = F.silu(tvae._group_norm(norm, x))
        got = tgn.group_norm_silu(x, 4, norm.weight, norm.bias, norm.eps)
    assert got.dtype == torch.float64
    assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max())


@pytest.mark.parametrize("batch,groups,span,itemsize", [
    (1, 32, 4 * 33 * 208 * 200, 2),  # the decoder's finest window
    (2, 32, 4 * 25 * 320 * 640, 2),  # the training encode
    (1, 32, 16 * 9 * 26 * 25, 2),  # the mid block
    (1, 32, 1 * 1 * 1 * 5, 4),  # a span under a vector
    (1, 1, 512 * 33 * 208 * 200, 2),  # one group: capped
])
def test_the_chunk_plan_fills_the_card(batch, groups, span, itemsize):
    """Enough blocks for four waves of eight on each of 132 SMs where the
    work allows, never a chunk under one vector a thread, at most 1024."""
    sms = 132
    s = tgn.splits(batch * groups, span, itemsize, sms)
    vectors = span * itemsize // 16
    assert 1 <= s <= tgn.MAX_SPLITS
    assert s == 1 or vectors // s >= tgn.THREADS
    if vectors // tgn.THREADS >= 4 * 8 * sms and s < tgn.MAX_SPLITS:
        assert batch * groups * s >= tgn.WAVES * tgn.BLOCKS_PER_SM * sms


def test_the_launch_refuses_a_cpu_tensor():
    x = _x((1, 8, 3, 4, 4))
    w, b = torch.ones(8), torch.zeros(8)
    with pytest.raises(ValueError, match="runs on cuda"):
        tgn.group_norm_silu_launch(x, 4, w, b, 1e-6)
    with pytest.raises(ValueError, match="groups"):
        tgn.group_norm_silu(x, 3, w, b, 1e-6)
    with pytest.raises(ValueError, match="both cy and cb"):
        tgn.group_norm_silu(x, 4, w, b, 1e-6, cy=x)


# --- the channels-last form ---------------------------------------------------

@pytest.mark.parametrize("frames", [9, 8])
@pytest.mark.parametrize("with_mod", [True, False])
@pytest.mark.parametrize("channels", [128, 256, 512])
def test_channels_last_plain_is_the_ncdhw_plain(channels, with_mod, frames):
    """The channels-last form's plain version (statistics over NDHWC rows,
    the modulation gathered from channels-last cy and cb) equals the NCDHW
    plain version at the VAE's widths, 32 groups, odd and even frame counts,
    with and without the modulation; its output is channels-last."""
    x = _x((1, channels, frames, 4, 6))
    w, b = _x((channels,), seed=3).abs() + 0.5, _x((channels,), seed=4)
    cy = cb = None
    if with_mod:
        lat = (1, channels, 5 if frames % 2 else 4, 2, 3)
        cy, cb = _x(lat, seed=5) * 0.2, _x(lat, seed=6) * 0.2
    want = tgn.group_norm_silu_plain(x, 32, w, b, 1e-6, cy, cb, True)
    cl = torch.channels_last_3d
    got = tgn.group_norm_silu(x.contiguous(memory_format=cl), 32, w, b, 1e-6,
                              None if cy is None else cy.contiguous(memory_format=cl),
                              None if cb is None else cb.contiguous(memory_format=cl), True)
    assert tgn.channels_last(got) and got.shape == want.shape
    assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_left_frames_at_a_clips_start_and_in_a_continuation(dtype):
    """With lead = 2 the output is the next causal conv's input: at a clip's
    start frame 0 repeated in front (the conv's causal padding), in a
    continuation chunk the conv's cache, each bit for bit; y itself is the
    form's output without a lead."""
    x = _x((2, 8, 5, 4, 6), dtype).contiguous(memory_format=torch.channels_last_3d)
    w, b = torch.rand(8) + 0.5, torch.randn(8)
    bare = tgn.group_norm_silu(x, 4, w, b, 1e-6)
    start = tgn.group_norm_silu(x, 4, w, b, 1e-6, lead=2)
    cache = _x((2, 8, 2, 4, 6), dtype, seed=7)
    cont = tgn.group_norm_silu(x, 4, w, b, 1e-6, lead=2, left=cache)
    for out in (start, cont):
        assert out.shape == (2, 8, 7, 4, 6) and tgn.channels_last(out) and out.dtype == dtype
        assert torch.equal(out[:, :, 2:], bare)
    assert torch.equal(start[:, :, :2], bare[:, :, :1].expand(-1, -1, 2, -1, -1))
    assert torch.equal(cont[:, :, :2], cache)
    # what conv_in's route builds: the same frames around any tensor
    assert torch.equal(tgn.with_left_frames(bare, 2, cache), cont)
    with pytest.raises(ValueError, match="left must be"):
        tgn.group_norm_silu(x, 4, w, b, 1e-6, lead=2, left=cache[:, :, :1])


@pytest.mark.parametrize("channels,groups,itemsize,takes", [
    (128, 32, 2, True), (256, 32, 2, True), (512, 32, 2, True),  # the VAE in bf16, fp16
    (128, 32, 4, True), (512, 32, 4, True),  # and in fp32
    (32, 32, 2, True), (64, 32, 4, True),  # a channel or two a group
    (96, 32, 2, False),  # three channels a group
    (4096, 32, 2, False),  # more vectors a row than threads
    (12, 4, 2, False),  # a row not whole vectors
])
def test_channels_last_widths_the_kernel_takes(channels, groups, itemsize, takes):
    assert tgn.takes_channels_last(channels, groups, itemsize) is takes
