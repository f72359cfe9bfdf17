"""The port's weight synthesis and int8 weight floor against the JAX
scripts (``scripts/int8_drift_report.py``'s ``realistic_params``,
``scripts/int8_weight_floor.py``), on the CPU at the tiny preset.

* Synthesis: the port's ``realistic_params`` against JAX's, leaf by leaf
  through the weight converter's names: each tensor's JAX leaf (path and
  shape, stacked or not), the ones/zeros of JAX's 1-D leaves, each leaf's
  std against fan_in^-0.5 (fan-in over the JAX layout, the layer axis
  included), and for the outlier family the per-channel gain spread on the
  output axis, shared by a stacked leaf's layers. Statistics, not draws:
  torch's cannot equal JAX's.
* The weight floor: the port's JSON against JAX's on the same bf16 weights
  and calib, within 1e-4 per value (the GPTQ rounding of two libraries
  agrees on ~99.5% of the codes, tests/test_torch_vae_quant.py); GPTQ on an
  indefinite tap Gram keeps round-to-nearest on both sides.
"""

from __future__ import annotations

import json
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dove_tpu import config as jcfg
from dove_tpu_torch import config as tcfg
from dove_tpu_torch import int8_drift_report as tdrift
from dove_tpu_torch import int8_weight_floor as tfloor
from dove_tpu_torch import weights as tweights
from test_torch_drift_report import _jax_trees, _keys, _load_script, _wide, jdrift
from torch_threads import two_torch_threads  # noqa: F401 (autouse)

FLOOR_TOL = 1e-4
STD_TOL = 0.2  # of fan_in^-0.5, on leaves of >= 1024 entries


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """This file's small torch work in one thread: beside the suite's other
    workers a full thread pool oversubscribes the cores (the int8 VAE
    modes' plain convolutions then ran tens of times slower)."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def _per_channel_log_rms(x: np.ndarray, axis: int) -> np.ndarray:
    other = tuple(i for i in range(x.ndim) if i != axis)
    return np.log(np.sqrt(np.mean(np.square(x.astype(np.float64)), axis=other)))


def _tagged_names(shapes, convert) -> dict[str, str]:
    """Each diffusers name -> the keystr of the JAX leaf it comes from: the
    converter run on a tree whose leaves hold their own index."""
    leaves = jax.tree_util.tree_leaves_with_path(shapes)
    paths = [jax.tree_util.keystr(p).lower() for p, _ in leaves]
    tagged = jax.tree_util.tree_unflatten(
        jax.tree_util.tree_structure(shapes),
        [np.full(leaf.shape, i, np.float32) for i, (_, leaf) in enumerate(leaves)])
    return {name: paths[int(arr.reshape(-1)[0])] for name, arr in convert(tagged).items()}


def _vae_part(s):
    """The VAE leaves the statistics test reads: a level of each half, the
    decoder's first conv and its output norm (SpatialNorm3d)."""
    return {"encoder": {"down_blocks": [s["encoder"]["down_blocks"][0]],
                        "norm_out": s["encoder"]["norm_out"]},
            "decoder": {"conv_in": s["decoder"]["conv_in"],
                        "up_blocks": [s["decoder"]["up_blocks"][0]],
                        "norm_out": s["decoder"]["norm_out"]}}


@pytest.mark.parametrize("family", ["gaussian", "outlier"])
def test_synthesis_statistics_leaf_by_leaf(family):
    cfg = jcfg.tiny_test()
    dit_j, vae_j, dit_s, vae_s = _jax_trees(cfg, family, vae_part=_vae_part)
    dit_t, vae_t = tdrift.empty_models(tcfg.tiny_test(), torch.float32, torch.device("cpu"))
    tdrift.realistic_params(dit_t, seed=1, family=family)
    tdrift.realistic_params(vae_t, seed=2, family=family)
    n_layers = cfg.dit.num_layers
    checked = set()
    spreads = {"out": [], "in": []}
    for model, tree, shapes, convert in (
            (dit_t, dit_j, dit_s, tweights.jax_dit_to_diffusers),
            (vae_t, vae_j, vae_s, tweights.jax_vae_to_diffusers)):
        ref = convert(tree)
        owner = _tagged_names(shapes, convert)
        ours = {k: v.numpy() for k, v in model.state_dict().items() if k in ref}
        assert sorted(ours) == sorted(ref)
        groups: dict[str, list[str]] = {}
        for name, arr in ours.items():
            path, stacked = tdrift.jax_leaf(name, arr.ndim)
            assert path == owner[name], name  # the converter, inverted
            groups.setdefault(path, []).append(name)
            assert stacked == name.startswith("transformer_blocks.")
        leaf_shapes = {jax.tree_util.keystr(p).lower(): leaf.shape
                       for p, leaf in jax.tree_util.tree_leaves_with_path(shapes)}
        for path, names in groups.items():
            jshape = leaf_shapes[path]
            assert tdrift.jax_shape(torch.Size(ours[names[0]].shape),
                                    names[0].startswith("transformer_blocks."),
                                    n_layers) == tuple(jshape), path
            a = np.stack([ours[n] for n in names])
            b = np.stack([ref[n] for n in names])
            if len(jshape) <= 1:  # the JAX script's ones / zeros
                assert np.all(a == b) and np.all((b == 0) | (b == 1)), path
                checked.add(names[0])
                continue
            fan_in = int(np.prod(jshape[:-1]))
            if a.size >= 1024:
                for x in (a, b):
                    assert abs(x.std() * fan_in ** 0.5 - 1.0) <= STD_TOL, (path, x.std())
                checked.add(names[0])
            if a.ndim >= 3 and a.shape[1] >= 32 and a[0].size >= 1024:
                # per output channel (torch dim 0 of each tensor) and per
                # input channel, over every layer of the leaf
                for axis, key in ((1, "out"), (2, "in")):
                    spreads[key].append((_per_channel_log_rms(a, axis).std(),
                                         _per_channel_log_rms(b, axis).std()))
                if len(names) > 1 and family == "outlier":
                    # the gains are the leaf's, so every layer has them
                    r_a = np.corrcoef(_per_channel_log_rms(a[0], 0),
                                      _per_channel_log_rms(a[1], 0))[0, 1]
                    r_b = np.corrcoef(_per_channel_log_rms(b[0], 0),
                                      _per_channel_log_rms(b[1], 0))[0, 1]
                    assert r_a > 0.5 and r_b > 0.5, (path, r_a, r_b)
    for want in ("transformer_blocks.0.attn1.to_q.weight", "patch_embed.proj.weight",
                 "transformer_blocks.0.ff.net.0.proj.weight", "norm_final.weight",
                 "decoder.up_blocks.0.resnets.0.conv1.conv.weight",
                 "encoder.down_blocks.0.resnets.0.norm1.weight"):
        assert want in checked, want
    out = np.median(np.array(spreads["out"]), axis=0)
    inn = np.median(np.array(spreads["in"]), axis=0)
    if family == "outlier":  # log-normal(0, 0.6) gains on the output axis only
        assert np.all(out > 0.45) and np.all(inn < 0.35), (out, inn)
    else:
        assert np.all(out < 0.2) and np.all(inn < 0.2), (out, inn)


# ---------------------------------------------------------------------------
# The weight floor
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("with_calib", [True, False])
def test_weight_floor_matches_jax(tmp_path, monkeypatch, with_calib):
    """Both scripts on the same bf16 weights (JAX's synthesis, the VAE
    widened to 64 channels so that its decoder quantizes) and the same
    calib npz (the port's calibration of those weights)."""
    family = "outlier"
    tiny_j = jcfg.tiny_test
    monkeypatch.setattr(jcfg, "tiny_test", lambda: _wide(tiny_j(), 1))
    # the script imports the synthesis from its neighbour module: this one
    monkeypatch.setitem(sys.modules, "int8_drift_report", jdrift)
    cfg_j = jcfg.tiny_test()
    _, vae_j, _, _ = _jax_trees(cfg_j, family, jnp.bfloat16)
    cfg_t = _wide(tcfg.tiny_test(), 1)
    vae = tweights.convert_vae(tweights.jax_vae_to_diffusers(vae_j), cfg_t.vae,
                               torch.bfloat16)
    calib_args = []
    calib = {}
    if with_calib:
        rng = np.random.default_rng(1)
        z = torch.as_tensor(rng.standard_normal((1, 8, 3, 8, 8)), dtype=torch.bfloat16)
        from dove_tpu_torch.models import vae as tvae

        _, stats = tvae.calibrate(
            lambda q: tvae.decoder_forward(cfg_t.vae, vae.decoder, q, None), z)
        calib = {k: v.float().numpy() for k, v in stats.items()}
        np.savez(tmp_path / "calib.npz", **calib)
        calib_args = ["--calib", str(tmp_path / "calib.npz")]
    out = tmp_path / "floor.json"
    monkeypatch.setenv("DOVE_JAX_CACHE", "off")
    monkeypatch.setattr(sys, "argv", ["int8_weight_floor.py", "--weights", family,
                                      "--preset", "tiny", "--out", str(out)] + calib_args)
    _load_script("int8_weight_floor").main()
    ref = json.loads(out.read_text())
    ours = tfloor.weight_floor(vae, calib, family)
    assert _keys(ours) == _keys(ref)
    assert len(ours["per_conv"]) > 0
    for k in ("weights_family", "quantizer", "metric"):
        assert ours[k] == ref[k]
    for k, v in ref.items():
        if isinstance(v, float):
            assert abs(ours[k] - v) <= FLOOR_TOL, k
    for name, row in ref["per_conv"].items():
        for k, v in row.items():
            if v is None:
                assert ours["per_conv"][name][k] is None
            else:
                assert abs(ours["per_conv"][name][k] - v) <= FLOOR_TOL, (name, k)
    assert (ref["median_output_rel_err"] is not None) == with_calib


def test_gptq_rounding_keeps_rtn_where_the_tap_gram_is_indefinite():
    """A tap autocorrelation from a small window need not be positive
    definite: JAX's Cholesky factor is then NaN and every column keeps its
    round-to-nearest codes; the port's rounding does the same, not raise."""
    from dove_tpu.ops import quant as jquant
    from dove_tpu_torch.ops import quant as tquant

    rng = np.random.default_rng(0)
    w = rng.standard_normal((3, 3, 3, 4, 5)).astype(np.float32)
    scale = (np.abs(w).reshape(-1, 5).max(axis=0) / 127.0).astype(np.float32)
    tapcorr = np.full((5, 5, 5), 0.9, np.float32)
    tapcorr[2, 2, 2] = 1.0
    tapcorr[2, 2, 3] = tapcorr[2, 2, 1] = -0.9  # no autocorrelation has these
    want = np.asarray(jquant.gptq_tap_rounding(jnp.asarray(w), jnp.asarray(scale),
                                               jnp.asarray(tapcorr)))
    got = tquant.gptq_tap_rounding(torch.from_numpy(w), torch.from_numpy(scale),
                                   torch.from_numpy(tapcorr)).numpy()
    rtn = np.clip(np.round(w / scale), -127, 127).astype(np.int8)
    np.testing.assert_array_equal(want, rtn)
    np.testing.assert_array_equal(got, rtn)
