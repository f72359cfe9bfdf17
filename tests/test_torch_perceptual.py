"""The port's VGG16, LPIPS, DISTS and Sobel edges against dove_tpu.

fp32 on the CPU, the same weights in both packages (JAX's seeded VGG16 with
biases moved off zero, carried across by ``weights.from_jax_vgg``) and the
same seeded numpy images: features with max and L2 pooling, the L2 pool, the
two distances and the edge maps, by value and by their gradient with respect
to the image. The state-dict loaders read files this test writes, in
torchvision's ``features.*`` and lpips's ``net.slice*`` layouts.
"""

from __future__ import annotations

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dove_tpu.eval import vgg as jvgg
from dove_tpu.train import losses as jlosses
from dove_tpu_torch import safetensors_io
from dove_tpu_torch import weights as tweights
from dove_tpu_torch.eval import dists as tdists
from dove_tpu_torch.eval import lpips as tlpips
from dove_tpu_torch.eval import vgg as tvgg
from dove_tpu_torch.train import losses as tlosses

torch.backends.cudnn.allow_tf32 = False

REL_TOL = 1e-5  # max |ours - ref| / max |ref|, fp32 through up to 13 convs
B, S = 2, 32


def _max_rel(ours, ref) -> float:
    ours, ref = np.asarray(ours, np.float64), np.asarray(ref, np.float64)
    return float(np.abs(ours - ref).max() / max(np.abs(ref).max(), 1e-30))


@pytest.fixture(scope="module")
def vgg_pair():
    """JAX's init_vgg16(PRNGKey(0)) with small seeded biases, and the same
    weights in the port."""
    params = jax.tree.map(np.asarray, jvgg.init_vgg16(jax.random.PRNGKey(0)))
    rng = np.random.default_rng(0)
    for stage in params:
        for conv in stage:
            conv["bias"] = 0.05 * rng.standard_normal(conv["bias"].shape).astype(np.float32)
    vgg, _ = tweights.from_jax_vgg(params)
    return params, vgg


def _images(seed: int, lo: float = 0.0, hi: float = 1.0, n: int = B) -> np.ndarray:
    return np.random.default_rng(seed).uniform(lo, hi, (n, S, S, 3)).astype(np.float32)


def _jax_value_and_grad(fn, x: np.ndarray, *args):
    val, vjp = jax.vjp(lambda a: fn(a, *args), jnp.asarray(x))
    cot = jax.tree.map(lambda v: jnp.asarray(
        np.random.default_rng(1).standard_normal(v.shape).astype(np.float32)), val)
    return val, vjp(cot)[0], cot


def _torch_value_and_grad(fn, x: np.ndarray, cot, *args):
    xt = torch.tensor(x, requires_grad=True)
    val = fn(xt, *args)
    vals = val if isinstance(val, (list, tuple)) else [val]
    cots = cot if isinstance(cot, (list, tuple)) else [cot]
    torch.autograd.backward(vals, [torch.from_numpy(np.asarray(c)) for c in cots])
    return val, xt.grad


def _check(ours, ref, what: str):
    err = _max_rel(ours, ref)
    assert err <= REL_TOL, f"{what}: max rel err {err:.3e}"


@pytest.mark.parametrize("pool", ["max", "l2"])
def test_vgg16_features_match_jax(vgg_pair, pool):
    params, vgg = vgg_pair
    x = _images(2, -2.0, 2.0)
    ref, ref_g, cot = _jax_value_and_grad(
        lambda a: jvgg.vgg16_features(params, a, pool=pool), x)
    # the port's features are NCHW
    cot_nchw = [np.transpose(np.asarray(c), (0, 3, 1, 2)) for c in cot]
    feats, g = _torch_value_and_grad(
        lambda a: tvgg.vgg16_features(vgg, a.permute(0, 3, 1, 2), pool), x, cot_nchw)
    assert [tuple(f.shape) for f in feats] == [
        (B, c, S >> i, S >> i) for i, (c, _) in enumerate(tvgg.VGG16_STAGES)]
    for i, (f, r) in enumerate(zip(feats, ref)):
        _check(f.detach().permute(0, 2, 3, 1).numpy(), r, f"stage {i} ({pool})")
    _check(g.numpy(), ref_g, f"d features / dx ({pool})")


def test_l2_pool_matches_jax():
    x = np.random.default_rng(3).standard_normal((B, 17, 18, 5)).astype(np.float32)
    x[:, :4, :4] = 0.0  # an all-zero window: the 1e-12 floor and its zero gradient
    ref, ref_g, cot = _jax_value_and_grad(jvgg._l2_pool, x)
    out, g = _torch_value_and_grad(
        lambda a: tvgg._l2_pool(a.permute(0, 3, 1, 2)).permute(0, 2, 3, 1), x, cot)
    assert out.shape == ref.shape == (B, 9, 9, 5)
    _check(out.detach().numpy(), ref, "l2 pool")
    _check(g.numpy(), ref_g, "d l2 pool / dx")


def test_lpips_distance_matches_jax(vgg_pair):
    params, vgg = vgg_pair
    rng = np.random.default_rng(4)
    lins_np = [rng.uniform(0, 1, (c,)).astype(np.float32) for c, _ in jvgg.VGG16_STAGES]
    x, y = _images(5, -1.0, 1.0), _images(6, -1.0, 1.0)
    lins_j = [jnp.asarray(w) for w in lins_np]
    ref, ref_g, cot = _jax_value_and_grad(
        lambda a: jvgg.lpips_distance(params, lins_j, a, jnp.asarray(y)), x)
    _, (lins_t,) = tweights.from_jax_vgg(params, [lins_np])
    d, g = _torch_value_and_grad(
        lambda a: tvgg.lpips_distance(vgg, lins_t, a, torch.from_numpy(y)), x, cot)
    assert d.shape == (B,) and float(d.min()) > 0
    _check(d.detach().numpy(), ref, "lpips")
    _check(g.numpy(), ref_g, "d lpips / dx")
    same = tvgg.lpips_distance(vgg, lins_t, torch.from_numpy(x), torch.from_numpy(x))
    np.testing.assert_allclose(same.numpy(), 0.0, atol=1e-6)


def test_dists_distance_matches_jax(vgg_pair):
    """The distance in fp32; its gradient in float64 (both packages take the
    statistics in fp32 all the same). In fp32 the gradient through 13 convs
    and DISTS's variance and covariance terms is conditioned so that JAX's
    own fp32 gradient lies 3e-5 (max abs, relative to the largest) from its
    float64 one at these inputs, the port's 1e-4: fp32 against fp32 measures
    rounding, float64 the function."""
    params, vgg = vgg_pair
    rng = np.random.default_rng(7)
    chans = [3] + [c for c, _ in jvgg.VGG16_STAGES]
    alpha = [rng.uniform(0, 1, (c,)).astype(np.float32) for c in chans]
    beta = [rng.uniform(0, 1, (c,)).astype(np.float32) for c in chans]
    x, y = _images(8), _images(9)
    ref = jvgg.dists_distance(params, [jnp.asarray(v) for v in alpha],
                              [jnp.asarray(v) for v in beta], jnp.asarray(x), jnp.asarray(y))
    _, (alpha_t, beta_t) = tweights.from_jax_vgg(params, [alpha, beta])
    d = tvgg.dists_distance(vgg, alpha_t, beta_t, torch.from_numpy(x), torch.from_numpy(y))
    assert d.shape == (B,) and float(d.min()) > 0
    _check(d.numpy(), ref, "dists")

    x, y = x[:1], y[:1]  # one image: float64 convolutions are slow on the CPU
    with jax.enable_x64(True):
        p64 = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), params)
        ref_g = jax.jit(jax.grad(lambda a: jnp.sum(jvgg.dists_distance(
            p64, [jnp.asarray(v, jnp.float64) for v in alpha],
            [jnp.asarray(v, jnp.float64) for v in beta], a,
            jnp.asarray(y, jnp.float64)))))(jnp.asarray(x, jnp.float64))
        ref_g = np.asarray(ref_g)
    assert ref_g.dtype == np.float64
    x64 = torch.tensor(x, dtype=torch.float64, requires_grad=True)
    tvgg.dists_distance(copy.deepcopy(vgg).double(), [a.double() for a in alpha_t],
                        [b.double() for b in beta_t], x64,
                        torch.tensor(y, dtype=torch.float64)).sum().backward()
    _check(x64.grad.numpy(), ref_g, "d dists / dx (float64)")

    a1, b1 = tvgg.init_dists_weights()
    assert [v.shape[0] for v in a1] == [v.shape[0] for v in b1] == chans
    same = tvgg.dists_distance(vgg, a1, b1, torch.from_numpy(y), torch.from_numpy(y))
    np.testing.assert_allclose(same.numpy(), 0.0, atol=1e-5)


def test_sobel_edges_match_jax():
    x = _images(10)
    ref, ref_g, cot = _jax_value_and_grad(jlosses.sobel_edges, x)
    out, g = _torch_value_and_grad(tlosses.sobel_edges, x, cot)
    assert out.shape == (B, S, S, 3)
    _check(out.detach().numpy(), ref, "sobel")
    _check(g.numpy(), ref_g, "d sobel / dx")


def test_frame_difference_l1_matches_jax():
    v = np.random.default_rng(11).standard_normal((2, 3, 4, 5, 3)).astype(np.float32)
    np.testing.assert_array_equal(
        tlosses.frame_difference_l1(torch.from_numpy(v)).numpy(),
        np.asarray(jlosses.frame_difference_l1(jnp.asarray(v))))


def test_init_vgg16_is_seeded_with_the_jax_distribution():
    a, b = tvgg.init_vgg16(0), tvgg.init_vgg16(0)
    convs = [c for stage in a.stages for c in stage]
    assert len(convs) == 13
    assert all(torch.equal(p, q) for p, q in zip(a.parameters(), b.parameters()))
    assert not any(p.requires_grad for p in a.parameters())
    assert not torch.equal(convs[0].weight, tvgg.init_vgg16(1).stages[0][0].weight)
    for conv in convs:  # normal, std sqrt(2 / (9 cin)), biases 0
        std = (2.0 / (9 * conv.in_channels)) ** 0.5
        assert abs(float(conv.weight.std()) / std - 1) < 0.1
        assert not conv.bias.any()


# ---------------------------------------------------------------------------
# State dicts and the metric loaders
# ---------------------------------------------------------------------------

# torchvision's VGG16 ``features`` indices of the 13 convs, and lpips's
# ``net.slice{k}`` split of the same indices
_FEATURE_IDX = (0, 2, 5, 7, 10, 12, 14, 17, 19, 21, 24, 26, 28)
_SLICES = (1, 1, 2, 2, 3, 3, 3, 4, 4, 4, 5, 5, 5)


def _state_dict(params, layout: str) -> dict[str, np.ndarray]:
    """The JAX VGG params as a torch state dict in ``layout``, plus a
    non-conv tensor the loaders must skip."""
    convs = [c for stage in params for c in stage]
    sd = {}
    for conv, idx, sl in zip(convs, _FEATURE_IDX, _SLICES):
        name = f"features.{idx}" if layout == "features" else f"net.slice{sl}.{idx}"
        sd[f"{name}.weight"] = np.ascontiguousarray(
            np.transpose(np.asarray(conv["kernel"]), (3, 2, 0, 1)))
        sd[f"{name}.bias"] = np.asarray(conv["bias"])
    sd["classifier.0.weight"] = np.zeros((4, 8), np.float32)
    return sd


@pytest.mark.parametrize("layout", ["features", "net.slice"])
def test_vgg16_from_torch_sd_matches_jax(vgg_pair, layout):
    params, vgg = vgg_pair
    sd = _state_dict(params, layout)
    ref = jvgg.vgg16_from_torch_sd(sd)
    ours = tvgg.vgg16_from_torch_sd({k: torch.from_numpy(v) for k, v in sd.items()})
    for stage_j, stage_t in zip(ref, ours.stages):
        for cj, ct in zip(stage_j, stage_t):
            np.testing.assert_array_equal(
                ct.weight.numpy(), np.transpose(np.asarray(cj["kernel"]), (3, 2, 0, 1)))
            np.testing.assert_array_equal(ct.bias.numpy(), np.asarray(cj["bias"]))
    x = torch.from_numpy(_images(12, -1.0, 1.0, n=1)).permute(0, 3, 1, 2)
    for a, b in zip(tvgg.vgg16_features(ours, x), tvgg.vgg16_features(vgg, x)):
        assert torch.equal(a, b)


def _write(sd: dict[str, np.ndarray], path, suffix: str):
    path = path.with_suffix(suffix)
    if suffix == ".safetensors":
        safetensors_io.save_file(sd, path)
    else:
        torch.save({k: torch.from_numpy(v) for k, v in sd.items()}, path)
    return path


@pytest.mark.parametrize("suffix", [".pt", ".safetensors"])
def test_metric_loaders_match_jax(vgg_pair, tmp_path, suffix):
    params, _ = vgg_pair
    rng = np.random.default_rng(13)
    chans = [3] + [c for c, _ in jvgg.VGG16_STAGES]
    dists_sd = _state_dict(params, "features")
    dists_sd["alpha"] = rng.uniform(0, 1, (1, sum(chans), 1, 1)).astype(np.float32)
    dists_sd["beta"] = rng.uniform(0, 1, (1, sum(chans), 1, 1)).astype(np.float32)
    lpips_sd = _state_dict(params, "net.slice")
    for k, (c, _) in enumerate(jvgg.VGG16_STAGES):
        lpips_sd[f"lin{k}.model.1.weight"] = rng.uniform(0, 1, (1, c, 1, 1)).astype(
            np.float32)
    pred = np.random.default_rng(14).uniform(0, 1, (2, S, S, 3)).astype(np.float32)
    gt = np.random.default_rng(15).uniform(0, 1, (2, S, S, 3)).astype(np.float32)
    for sd, name, jload, tload in ((dists_sd, "dists", jvgg.load_dists, tvgg.load_dists),
                                   (lpips_sd, "lpips", jvgg.load_lpips, tvgg.load_lpips)):
        path = _write(sd, tmp_path / name, suffix)
        ref = jload(path)(pred, gt)
        ours = tload(path, device="cpu")(pred, gt)
        assert ours > 0
        np.testing.assert_allclose(ours, ref, rtol=REL_TOL)


def test_metric_factories_need_weights(monkeypatch, tmp_path):
    for mod, fn, env in ((tdists, "dists_metric", "DOVE_DISTS_WEIGHTS"),
                         (tlpips, "lpips_metric", "DOVE_LPIPS_WEIGHTS")):
        monkeypatch.delenv(env, raising=False)
        with pytest.raises(NotImplementedError, match=env):
            getattr(mod, fn)(device="cpu")
        monkeypatch.setenv(env, str(tmp_path / "missing.pt"))
        with pytest.raises(NotImplementedError, match=env):
            getattr(mod, fn)(device="cpu")
    with pytest.raises(ValueError, match="13 convs"):
        tvgg.vgg16_from_torch_sd({"features.0.weight": torch.zeros(64, 3, 3, 3),
                                  "features.0.bias": torch.zeros(64)})


@pytest.mark.parametrize("kind,edge", [("dists", False), ("lpips", True)])
def test_perceptual_fn_matches_jax(vgg_pair, tmp_path, kind, edge):
    """make_perceptual_fn on one weight file in both packages, by value, and
    for LPIPS (with the edge maps) by the gradient with respect to the
    prediction: [B, F, H, W, 3] in [0, 1]. DISTS's fp32 gradient is
    conditioned past the bar (see test_dists_distance_matches_jax, which
    holds it in float64)."""
    params, _ = vgg_pair
    rng = np.random.default_rng(16)
    sd = _state_dict(params, "features")
    if kind == "dists":
        sd["alpha"] = rng.uniform(0, 1, (1, 1475, 1, 1)).astype(np.float32)
        sd["beta"] = rng.uniform(0, 1, (1, 1475, 1, 1)).astype(np.float32)
    else:
        for k, (c, _) in enumerate(jvgg.VGG16_STAGES):
            sd[f"lins.{k}.model.1.weight"] = rng.uniform(0, 1, (1, c, 1, 1)).astype(
                np.float32)
    path = _write(sd, tmp_path / "w", ".pt")
    pred = rng.uniform(0, 1, (1, 2, S, S, 3)).astype(np.float32)
    hq = rng.uniform(0, 1, (1, 2, S, S, 3)).astype(np.float32)
    jfn = jlosses.make_perceptual_fn(kind, edge_aware=edge, weights_path=str(path))
    ref, ref_g = jax.value_and_grad(lambda p: jfn(p, jnp.asarray(hq)))(jnp.asarray(pred))
    tfn = tlosses.make_perceptual_fn(kind, edge_aware=edge, weights_path=str(path))
    p = torch.tensor(pred, requires_grad=True)
    val = tfn(p, torch.from_numpy(hq))
    val.backward()
    np.testing.assert_allclose(float(val), float(ref), rtol=REL_TOL)
    if kind == "lpips":
        _check(p.grad.numpy(), ref_g, f"d {kind} / d pred")
    with pytest.raises(ValueError, match="unknown perceptual"):
        tlosses.make_perceptual_fn("ssim")
