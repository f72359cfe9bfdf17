"""The port's NIQE, MUSIQ and MANIQA against dove_tpu's (CPU).

NIQE runs in float64 on both sides: the per-patch features within 1e-8
relative, every (A)GGD fit landing on the JAX package's grid index, the
score within 1e-8 relative, the .npz and .mat loaders equal. MUSIQ and
MANIQA at the tiny configs of tests/test_musiq.py and tests/test_maniqa.py,
from one seeded state dict in the published layout that both packages load
(the loaders give the same tensors): MUSIQ's tokens within the resize bar
and its scores within 1e-4 relative (also with byte input and split q, k,
v); MANIQA's forward and its crop protocol (the same crops, also on a frame
reflect-padded to the crop size) within 1e-4 relative.
"""

from __future__ import annotations

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dove_tpu.eval import maniqa as jmaniqa
from dove_tpu.eval import musiq as jmusiq
from dove_tpu.eval import niqe as jniqe
from dove_tpu_torch.eval import maniqa as tmaniqa
from dove_tpu_torch.eval import musiq as tmusiq
from dove_tpu_torch.eval import niqe as tniqe
from test_maniqa import CFG as MANIQA_TINY
from test_maniqa import _official_layout_sd
from test_musiq import CFG as MUSIQ_TINY
from test_musiq import _random_sd
from test_niqe import _textured
from test_torch_resize import ATOL as RESIZE_ATOL
from torch_threads import two_torch_threads  # noqa: F401 (autouse)

NIQE_REL = 1e-8
SCORE_REL = 1e-4


def _rel(a: float, b: float) -> float:
    return abs(a - b) / max(abs(b), 1e-30)


def _assert_same_module(a: torch.nn.Module, b: torch.nn.Module) -> None:
    sa, sb = a.state_dict(), b.state_dict()
    assert sa.keys() == sb.keys()
    for k in sa:
        assert torch.equal(sa[k], sb[k]), k


# ---------------------------------------------------------------------------
# NIQE
# ---------------------------------------------------------------------------

def _niqe_frames(seed: int, n: int = 2, h: int = 200, w: int = 300) -> np.ndarray:
    """Natural-ish RGB frames in [0, 1] (float32), two 96-patch rows."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        g = _textured(rng, 192, 288)
        rgb = np.stack([g, np.roll(g, 3, 0), np.roll(g, 5, 1)], -1) / 255.0
        out.append(np.pad(rgb, ((0, h - 192), (0, w - 288), (0, 0)), mode="edge"))
    return np.clip(np.stack(out), 0, 1).astype(np.float32)


def _pristine(seed: int) -> tuple[np.ndarray, np.ndarray]:
    rng = np.random.default_rng(seed)
    feats = np.concatenate([jniqe.niqe_features(_textured(rng)) for _ in range(3)])
    a = rng.normal(0, 0.05, (36, 36))
    return feats.mean(0), np.cov(feats, rowvar=False) + a @ a.T + 1e-3 * np.eye(36)


def test_niqe_features_and_fits_match_jax():
    frames = _niqe_frames(0)
    feats, keep, idxs = tniqe.niqe_features(
        tniqe.to_gray255(torch.from_numpy(frames)).double())
    alpha_cols = [0, 2, 6, 10, 14, 18, 20, 24, 28, 32]
    for f, k, ix, frame in zip(feats, keep, idxs, frames):
        ref = jniqe.niqe_features(jniqe._to_gray255(frame))
        ours = f[k].numpy()
        assert ours.shape == ref.shape
        np.testing.assert_allclose(ours, ref, rtol=NIQE_REL, atol=0)
        ref_idx = np.argmin(np.abs(ref[:, alpha_cols][..., None] - jniqe._GAM), -1)
        np.testing.assert_array_equal(ix[k].numpy(), ref_idx)


def test_niqe_metric_and_loaders_match_jax(tmp_path):
    from scipy.io import savemat

    mu, cov = _pristine(1)
    np.savez(tmp_path / "niqe.npz", mu=mu, cov=cov)
    savemat(tmp_path / "niqe.mat", {"mu_prisparam": mu[None], "cov_prisparam": cov})
    for name in ("niqe.npz", "niqe.mat"):
        for a, b in zip(tniqe.load_niqe_params(str(tmp_path / name)),
                        jniqe.load_niqe_params(str(tmp_path / name))):
            np.testing.assert_array_equal(a, b)
    frames = _niqe_frames(2, n=3)
    ref = jniqe.niqe_metric(str(tmp_path / "niqe.npz"))(frames)
    ours = tniqe.niqe_metric(str(tmp_path / "niqe.npz"), device="cpu")(frames)
    assert np.isfinite(ours)
    assert _rel(ours, ref) <= NIQE_REL, (ours, ref)
    with pytest.raises(ValueError, match="smaller than NIQE block"):
        tniqe.niqe_metric(str(tmp_path / "niqe.npz"), device="cpu")(frames[:, :90])


def test_niqe_half_downscale_matches_matlab_weights():
    img = np.random.default_rng(3).uniform(0, 255, (1, 96, 64))
    ours = tniqe.matlab_bicubic_half(torch.from_numpy(img))[0].numpy()
    np.testing.assert_allclose(ours, jniqe._matlab_bicubic_half(img[0]), rtol=1e-12)


# ---------------------------------------------------------------------------
# MUSIQ
# ---------------------------------------------------------------------------

def _musiq_patch(monkeypatch):
    cfg = tmusiq.MUSIQConfig(**dataclasses.asdict(MUSIQ_TINY))
    monkeypatch.setattr(jmusiq, "MUSIQConfig", lambda: MUSIQ_TINY)
    monkeypatch.setattr(tmusiq, "MUSIQConfig", lambda: cfg)
    return cfg


def test_musiq_tokens_match_jax():
    cfg = tmusiq.MUSIQConfig(**dataclasses.asdict(MUSIQ_TINY))
    frames = np.random.default_rng(4).random((2, 27, 41, 3)).astype(np.float32)
    patches, hse, scale = tmusiq.multiscale_tokens(cfg, torch.from_numpy(frames))
    for i, frame in enumerate(frames):
        ref_p, ref_h, ref_s = jmusiq.multiscale_tokens(MUSIQ_TINY, frame)
        np.testing.assert_array_equal(hse, ref_h)
        np.testing.assert_array_equal(scale, ref_s)
        np.testing.assert_allclose(patches[i].numpy(), ref_p, rtol=0,
                                   atol=RESIZE_ATOL["linear"])


@pytest.mark.parametrize("variant", ["fused", "split_byte"])
def test_musiq_loader_and_metric_match_jax(tmp_path, monkeypatch, variant):
    cfg = _musiq_patch(monkeypatch)
    sd = _random_sd(MUSIQ_TINY, seed=5)
    if variant == "split_byte":  # split q, k, v under a wrapper prefix; [0, 255]
        for i in range(MUSIQ_TINY.num_layers):
            for leaf in ("weight", "bias"):
                q, k, v = sd.pop(f"transformer.{i}.attn.qkv.{leaf}").chunk(3)
                for n, t in zip("qkv", (q, k, v)):
                    sd[f"transformer.{i}.attn.{n}.{leaf}"] = t
        sd = {f"module.{k}": v for k, v in sd.items()}
        monkeypatch.setenv("DOVE_MUSIQ_INPUT", "byte")
    path = tmp_path / "musiq.pt"
    torch.save(sd, path)
    _assert_same_module(tmusiq.load_musiq(str(path), cfg),
                        tmusiq.from_jax_musiq(jmusiq.load_musiq(str(path), MUSIQ_TINY), cfg))
    frames = np.random.default_rng(6).random((3, 30, 44, 3)).astype(np.float32)
    monkeypatch.setenv("DOVE_MUSIQ_WEIGHTS", str(path))
    ref = jmusiq.musiq_metric()(frames)
    ours = tmusiq.musiq_metric(device="cpu")(frames)
    assert _rel(ours, ref) <= SCORE_REL, (ours, ref)


def test_musiq_converter_reports_unmatched_keys():
    sd = {k: v.numpy() for k, v in _random_sd(MUSIQ_TINY).items()}
    sd["transformer.0.attn.extra.weight"] = np.zeros(3, np.float32)
    cfg = tmusiq.MUSIQConfig(**dataclasses.asdict(MUSIQ_TINY))
    with pytest.raises(ValueError, match="1 unmatched checkpoint keys"):
        tmusiq.convert_state_dict(sd, cfg)


# ---------------------------------------------------------------------------
# MANIQA
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def maniqa_sd():
    return _official_layout_sd(MANIQA_TINY, np.random.default_rng(7))


def test_maniqa_forward_matches_jax(maniqa_sd):
    cfg = tmaniqa.MANIQAConfig(**dataclasses.asdict(MANIQA_TINY))
    params = jmaniqa.convert_state_dict(maniqa_sd, MANIQA_TINY)
    model = tmaniqa.convert_state_dict(maniqa_sd, cfg)
    _assert_same_module(model, tmaniqa.from_jax_maniqa(params, cfg))
    imgs = np.random.default_rng(8).random((3, 32, 32, 3)).astype(np.float32)
    with torch.no_grad():
        ours = model(torch.from_numpy(imgs)).numpy()
    ref = np.asarray(jmaniqa.maniqa_forward(MANIQA_TINY, params, jnp.asarray(imgs)))
    np.testing.assert_allclose(ours, ref, rtol=SCORE_REL, atol=0)


def test_maniqa_loader_and_crop_protocol_match_jax(tmp_path, monkeypatch, maniqa_sd):
    """The JAX package's maniqa_metric jit-compiles a forward whose shifted
    Swin mask is built in NumPy from a traced array (dove_tpu/eval/maniqa.py
    :167), so under jit it raises; its metric runs here with jax.jit made
    the identity, the rest of its code as it is."""
    import jax

    monkeypatch.setattr(jax, "jit", lambda fn, *a, **k: fn)
    cfg = tmaniqa.MANIQAConfig(**dataclasses.asdict(MANIQA_TINY))
    monkeypatch.setattr(jmaniqa, "MANIQAConfig", lambda: MANIQA_TINY)
    monkeypatch.setattr(tmaniqa, "MANIQAConfig", lambda: cfg)
    path = tmp_path / "maniqa.pt"
    torch.save({"state_dict": {f"module.{k}": torch.tensor(v) for k, v in maniqa_sd.items()}},
               path)
    _assert_same_module(tmaniqa.load_maniqa(str(path)),
                        tmaniqa.from_jax_maniqa(jmaniqa.load_maniqa(str(path))[1], cfg))
    monkeypatch.setenv("DOVE_MANIQA_WEIGHTS", str(path))
    monkeypatch.setenv("DOVE_MANIQA_CROPS", "3")
    rng = np.random.default_rng(9)
    for shape in ((5, 40, 52, 3), (2, 20, 40, 3)):  # the second reflect-padded
        frames = rng.random(shape).astype(np.float32)
        ref = jmaniqa.maniqa_metric()(frames)
        ours = tmaniqa.maniqa_metric(device="cpu")(frames)
        assert _rel(ours, ref) <= SCORE_REL, (shape, ours, ref)


def test_maniqa_crop_draws_follow_the_protocol():
    rng = np.random.default_rng(0)
    want = [(rng.integers(0, 9, 4), rng.integers(0, 17, 4)) for _ in range(3)]
    got = tmaniqa.crop_origins([(40, 48)] * 3, 32, 4)
    for (wy, wx), (gy, gx) in zip(want, got):
        np.testing.assert_array_equal(wy, gy)
        np.testing.assert_array_equal(wx, gx)


def test_swin_pieces_match_jax():
    x = np.random.default_rng(10).normal(size=(2, 8, 8, 3)).astype(np.float32)
    wins = tmaniqa.window_partition(torch.from_numpy(x), 4)
    np.testing.assert_array_equal(wins.numpy(),
                                  np.asarray(jmaniqa._window_partition(jnp.asarray(x), 4)))
    back = tmaniqa.window_reverse(wins, 4, 2, 8, 8)
    np.testing.assert_array_equal(back.numpy(), x)
    np.testing.assert_array_equal(tmaniqa.shift_mask(8, 8, 4, 2),
                                  jmaniqa._shift_mask(8, 8, 4, 2))
    table = np.arange(49 * 2, dtype=np.float32).reshape(49, 2)
    ref = np.asarray(jmaniqa._rel_pos_bias(jnp.asarray(table), 4))
    ours = table[tmaniqa.relative_position_index(4)].reshape(16, 16, 2).transpose(2, 0, 1)
    np.testing.assert_array_equal(ours, ref)
