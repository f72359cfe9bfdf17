"""The fused path's geometry, stitchers, tiled VAE APIs and device upscale
against dove_tpu's (fp32, CPU).

The tile planner and both stitchers equal JAX's exactly, on the golden cases
of tests/test_tiling.py and on a seeded sweep; the stitchers also raise where
JAX's does. The feathered VAE tilers run the tiny_test() VAE of both packages
from the same weights and are held at atol 1e-4. The fused path's bilinear
upscale on the device is held within 1e-5 of the JAX package's two host
upscales (cv2's INTER_LINEAR and ``native.upscale_bilinear``, which falls back
to cv2 when its library is not built).
"""

from __future__ import annotations

import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dove_tpu import config as jcfg
from dove_tpu import native
from dove_tpu import tiling as jtiling
from dove_tpu.io import video as jvideo
from dove_tpu.models import vae as jvae
from dove_tpu_torch import config as tcfg
from dove_tpu_torch import tiling
from dove_tpu_torch import weights as tweights
from dove_tpu_torch.io import video as tvideo
from dove_tpu_torch.models import vae as tvae
from dove_tpu_torch.pipeline import bilinear_upscale

ATOL = 1e-4
UPSCALE_ATOL = 1e-5

GOLDEN_TILES = [
    (720, 1280, (384, 384), (32, 32)),
    (192, 320, (0, 0), (32, 32)),
    (720, 1280, (768, 768), (64, 64)),
    (256, 384, (128, 192), (32, 64)),
    (288, 512, (256, 256), (32, 32)),
]

PLANS = [
    (33, 192, 320, 16, (128, 128), 8, (32, 32)),
    (33, 720, 1280, 16, (384, 384), 8, (32, 32)),
    (33, 768, 1280, 16, (256, 256), 8, (32, 32)),
    (97, 288, 512, 24, (160, 224), 8, (32, 32)),
    (9, 96, 96, 0, (0, 0), 8, (32, 32)),
    (41, 144, 176, 16, (96, 112), 8, (16, 16)),
    (7, 96, 96, 16, (0, 0), 8, (32, 32)),
    (9, 32, 200, 0, (128, 128), 8, (32, 32)),
    (33, 192, 320, 16, (128, 128), 7, (31, 31)),
]


def _sweep(n: int, seed: int = 0):
    """Seeded plan arguments: sizes, tiles larger than the overlap, odd
    overlaps, tiles larger than the frame."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        F = int(rng.integers(1, 60))
        H, W = (int(x) for x in rng.integers(8, 400, 2))
        oh, ow = (int(x) for x in rng.integers(0, 40, 2))
        th, tw = oh + int(rng.integers(1, 300)), ow + int(rng.integers(1, 300))
        ot = int(rng.integers(0, 12))
        chunk = int(rng.choice([0, ot + int(rng.integers(1, 24))]))
        out.append((F, H, W, chunk, (th, tw), ot, (oh, ow)))
    return out


def test_the_720p_frame_at_384_is_one_band_of_three_tiles():
    assert tiling.spatial_tiles(720, 1280, (384, 384), (32, 32)) == [
        (0, 720, 0, 384), (0, 720, 352, 736), (0, 720, 704, 1280)]
    tiles = tiling.plan_tiles(33, 720, 1280, 16, (384, 384), 8, (32, 32))
    assert tiling.tile_geometries(tiles) == {(16, 720, 384): 4, (17, 720, 384): 2,
                                             (16, 720, 576): 2, (17, 720, 576): 1}


@pytest.mark.parametrize("case", GOLDEN_TILES)
def test_spatial_tiles_golden_match_jax(case):
    H, W, tile, overlap = case
    assert tiling.spatial_tiles(H, W, tile, overlap) == jtiling.spatial_tiles(
        H, W, tile, overlap)


@pytest.mark.parametrize("sweep", [False, True], ids=["cases", "seeded"])
def test_plan_and_geometries_match_jax(sweep):
    for args in _sweep(200) if sweep else PLANS:
        ref = jtiling.plan_tiles(*args)
        ours = tiling.plan_tiles(*args)
        assert [dataclass_tuple(t) for t in ours] == [dataclass_tuple(t) for t in ref], args
        assert tiling.tile_geometries(ours) == jtiling.tile_geometries(ref), args
        H, W, tile, ohw = args[1], args[2], args[4], args[6]
        assert tiling.spatial_tiles(H, W, tile, ohw) == jtiling.spatial_tiles(
            H, W, tile, ohw), args


def test_axis_tiles_refuse_a_tile_no_larger_than_the_overlap():
    for mod in (tiling, jtiling):
        with pytest.raises(ValueError, match="greater than overlap"):
            mod.spatial_tiles(64, 64, (32, 32), (32, 32))


def dataclass_tuple(t) -> tuple:
    return (t.t_start, t.t_end, t.h_start, t.h_end, t.w_start, t.w_end)


def _stitch_all(stitcher, tiles, video, wrap):
    for t in tiles:
        stitcher.add(t, wrap(video[:, t.t_start:t.t_end, t.h_start:t.h_end,
                                   t.w_start:t.w_end]))
    return stitcher.finalize()


@pytest.mark.parametrize("args", PLANS[:4] + _sweep(6, seed=1))
def test_stitchers_equal_jax(args):
    """A random volume stitched from the plan's tiles, each tile's data
    shifted by its own offset so that which tile wrote a pixel shows, by
    JAX's Stitcher, the port's NumPy one and the port's torch one: bit for
    bit equal."""
    F, H, W, chunk, tile, ot, ohw = args
    tiles = jtiling.plan_tiles(*args)
    eff = ot if chunk > 0 else 0
    rng = np.random.default_rng(2)
    video = rng.standard_normal((3, F, H, W)).astype(np.float32)
    shifts = {dataclass_tuple(t): np.float32(i) for i, t in enumerate(tiles)}

    def datas(stitcher, wrap):
        for t in tiles:
            d = video[:, t.t_start:t.t_end, t.h_start:t.h_end, t.w_start:t.w_end]
            stitcher.add(t, wrap(d + shifts[dataclass_tuple(t)]))
        return stitcher.finalize()

    ref = datas(jtiling.Stitcher(3, F, H, W, eff, ohw), lambda d: d)
    ours_np = datas(tiling.Stitcher(3, F, H, W, eff, ohw), lambda d: d)
    ours_t = datas(tiling.TorchStitcher(3, F, H, W, eff, ohw, device="cpu"),
                   torch.from_numpy)
    np.testing.assert_array_equal(ours_np, ref)
    np.testing.assert_array_equal(ours_t.numpy(), ref)


@pytest.mark.parametrize("fault", ["uncovered", "twice", "shape"])
def test_stitchers_raise_where_jax_does(fault):
    args = (17, 64, 96, 8, (64, 64), 4, (32, 32))
    tiles = jtiling.plan_tiles(*args)
    video = np.zeros((3, 17, 64, 96), np.float32)
    if fault == "uncovered":
        tiles = tiles[:-1]
    elif fault == "twice":
        tiles = tiles + tiles[:1]
    expect = ValueError if fault == "shape" else RuntimeError
    for make, wrap in ((lambda: jtiling.Stitcher(3, 17, 64, 96, 4, (32, 32)), None),
                       (lambda: tiling.Stitcher(3, 17, 64, 96, 4, (32, 32)), None),
                       (lambda: tiling.TorchStitcher(3, 17, 64, 96, 4, (32, 32)),
                        torch.from_numpy)):
        st = make()
        w = wrap or (lambda d: d)
        with pytest.raises(expect):
            if fault == "shape":
                st.add(tiles[0], w(video[:, :3, :5, :5]))
            else:
                _stitch_all(st, tiles, video, w)


# ---------------------------------------------------------------------------
# The VAE's feathered tilers
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def vae_pair():
    cfg_j = jcfg.tiny_test()
    tree = jax.tree.map(np.asarray, jvae.init_vae_params(jax.random.PRNGKey(0), cfg_j.vae))
    cfg_t = tcfg.tiny_test()
    vae = tweights.convert_vae(tweights.jax_vae_to_diffusers(tree), cfg_t.vae,
                               torch.float32)
    return cfg_j.vae, jax.tree.map(jnp.asarray, tree), cfg_t.vae, vae


def _video(shape, seed):
    return np.random.default_rng(seed).uniform(-1, 1, shape).astype(np.float32)


def test_tiled_encode_and_decode_match_jax(vae_pair):
    """64x64 frames against the tiny VAE's 32-pixel tiles: 3x3 feathered
    tiles each way."""
    cfg_j, params, cfg_t, vae = vae_pair
    video = _video((1, 5, 64, 64, 3), 3)
    ref_m = np.asarray(jvae.tiled_encode_moments(cfg_j, params, jnp.asarray(video)))
    with torch.inference_mode():
        m = tvae.tiled_encode_moments(cfg_t, vae, torch.from_numpy(video))
    assert m.shape == ref_m.shape == (1, 2, 8, 8, 16)
    np.testing.assert_allclose(m.numpy(), ref_m, atol=ATOL, rtol=0)

    lat = np.array(ref_m[..., :8])
    ref_px = np.asarray(jvae.tiled_decode(cfg_j, params, jnp.asarray(lat)))
    with torch.inference_mode():
        px = tvae.tiled_decode(cfg_t, vae, torch.from_numpy(lat))
    assert px.shape == ref_px.shape == (1, 8, 64, 64, 3)
    np.testing.assert_allclose(px.numpy(), ref_px, atol=ATOL, rtol=0)


def test_tilers_take_one_call_when_the_input_fits(vae_pair):
    """A 32x32 clip fits one tile: the tiled encode and decode are the plain
    encode and decode bit for bit."""
    _, _, cfg_t, vae = vae_pair
    video = torch.from_numpy(_video((1, 5, 32, 32, 3), 4))
    with torch.inference_mode():
        plain = tvae.encode_moments(cfg_t, vae, video)
        assert torch.equal(tvae.tiled_encode_moments(cfg_t, vae, video), plain)
        lat = plain[..., :8]
        assert torch.equal(tvae.tiled_decode(cfg_t, vae, lat),
                           tvae.decode(cfg_t, vae, lat))


# ---------------------------------------------------------------------------
# The fused path's upscale
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("scale", [1, 4])
def test_device_upscale_matches_the_host_upscales(scale):
    frames = np.random.default_rng(5).uniform(0, 1, (3, 12, 20, 3)).astype(np.float32)
    ours = bilinear_upscale(torch.from_numpy(frames)[None], scale)[0].numpy()
    cv2_ref = jvideo.bilinear_upscale(frames, scale, "bilinear")
    native_ref = native.upscale_bilinear(frames, scale, normalize=True)
    assert ours.shape == cv2_ref.shape == (3, 12 * scale, 20 * scale, 3)
    np.testing.assert_allclose(ours, cv2_ref, atol=UPSCALE_ATOL, rtol=0)
    np.testing.assert_allclose(ours * 2.0 - 1.0, native_ref, atol=UPSCALE_ATOL, rtol=0)


def test_host_upscale_modes(monkeypatch):
    """bicubic goes through cv2 as in JAX; without cv2 a non-bilinear mode
    raises, naming the mode; an unknown mode raises."""
    frames = np.random.default_rng(6).uniform(0, 1, (2, 8, 8, 3)).astype(np.float32)
    np.testing.assert_array_equal(tvideo.bilinear_upscale(frames, 4, "bicubic"),
                                  jvideo.bilinear_upscale(frames, 4, "bicubic"))
    with pytest.raises(ValueError, match="unknown upscale mode"):
        tvideo.bilinear_upscale(frames, 4, "sinc")
    monkeypatch.setitem(sys.modules, "cv2", None)
    for mode in ("bicubic", "area", "lanczos"):
        with pytest.raises(RuntimeError, match=f"'{mode}' needs OpenCV"):
            tvideo.bilinear_upscale(frames, 4, mode)
