"""The port's int8 drift report against the JAX script
(``scripts/int8_drift_report.py``), on the CPU at the tiny preset; its
weight synthesis and the weight floor are in tests/test_torch_weight_floor.py.

* Reports: JAX's ``realistic_params`` carried into the port
  (``weights.from_jax_params``); ``int8w`` and ``int8-dit`` against the JAX
  script's own reports in fp32: ``rel_err`` within 5% relative, PSNR within
  0.5 dB, the same keys. ``--calib_out``'s npz against JAX's calibration
  on the same weights and x0: the same keys, amax within 1e-5 relative,
  tapcorr within 1e-5 of JAX's statistic taken in float64. ``int8-dit-dec --exclude lowres`` and ``int8`` run through the
  port's entry point alone on a VAE widened to 64 channels, and so do the
  2B family's ``bf16`` and ``int8-dit`` runs at tiny widths (XLA's int8
  convolution on the CPU is too slow for a JAX side; tests/
  test_torch_int8_pipeline.py holds those modes at parity).
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import os
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dove_tpu import config as jcfg
from dove_tpu.models.dit import init_dit_params
from dove_tpu.models.vae import init_vae_params
from dove_tpu_torch import config as tcfg
from dove_tpu_torch import int8_drift_report as tdrift
from dove_tpu_torch import weights as tweights
from test_torch_dit import golden_config

REPO = Path(__file__).resolve().parents[1]
# one frame chunk in the encoder and the decoder: XLA's compile of the JAX
# pipeline grows with the chunks it unrolls
FIXTURE = ["--frames", "5", "--height", "16", "--width", "16"]
F, H, W = 5, 16, 16
REL_ERR_RTOL = 0.05
PSNR_TOL = 0.5  # dB
CALIB_TOL = 1e-5


def _load_script(name: str):
    """A script of scripts/ as a module, without its persistent-cache side
    effect on this process."""
    prev = os.environ.get("DOVE_JAX_CACHE")
    os.environ["DOVE_JAX_CACHE"] = "off"
    try:
        spec = importlib.util.spec_from_file_location(f"jax_{name}", REPO / "scripts" / f"{name}.py")
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
    finally:
        if prev is None:
            os.environ.pop("DOVE_JAX_CACHE", None)
        else:
            os.environ["DOVE_JAX_CACHE"] = prev
    return mod


jdrift = _load_script("int8_drift_report")
_SYNTHESIZED: dict = {}
_jax_realistic_params = jdrift.realistic_params


def _realistic_params_once(shapes, seed: int, dtype=jnp.bfloat16, family: str = "gaussian"):
    """The JAX script's synthesis (one jit per leaf, seconds per tree on the
    CPU), kept per tree and arguments: it is deterministic, and the script's
    runs here ask for the same trees again."""
    key = (str(jax.tree_util.tree_structure(shapes)),
           tuple(leaf.shape for leaf in jax.tree_util.tree_leaves(shapes)),
           seed, jnp.dtype(dtype).name, family)
    if key not in _SYNTHESIZED:
        _SYNTHESIZED[key] = _jax_realistic_params(shapes, seed, dtype, family)
    return _SYNTHESIZED[key]


jdrift.realistic_params = _realistic_params_once


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """This file's small torch work in one thread: beside the suite's other
    workers a full thread pool oversubscribes the cores (the int8 VAE
    modes' plain convolutions then ran tens of times slower)."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def _wide(cfg, levels: int = 3):
    """tiny with a 64-channel VAE: the int8 modes quantize its convs (three
    levels, so that "lowres" leaves a level quantized)."""
    return dataclasses.replace(cfg, vae=dataclasses.replace(
        cfg.vae, block_out_channels=(64,) * levels))


def _jax_trees(cfg, family: str, dtype=jnp.float32, vae_part=None):
    """JAX's synthesized trees (NumPy) and their shapes; ``vae_part`` picks
    a part of the VAE's shape tree (a smaller tree of the same paths)."""
    key = jax.random.PRNGKey(0)
    dit_s = jax.eval_shape(lambda k: init_dit_params(k, cfg.dit, dtype), key)
    vae_s = jax.eval_shape(lambda k: init_vae_params(k, cfg.vae, dtype), key)
    if vae_part is not None:
        vae_s = vae_part(vae_s)
    dit = jdrift.realistic_params(dit_s, seed=1, dtype=dtype, family=family)
    vae = jdrift.realistic_params(vae_s, seed=2, dtype=dtype, family=family)
    return (jax.tree.map(lambda x: np.asarray(x, np.float32), dit),
            jax.tree.map(lambda x: np.asarray(x, np.float32), vae), dit_s, vae_s)


# ---------------------------------------------------------------------------
# Reports
# ---------------------------------------------------------------------------

def _run_jax_main(argv: list[str], monkeypatch) -> None:
    monkeypatch.setattr(sys, "argv", ["int8_drift_report.py", "--cpu", "--preset", "tiny"]
                        + FIXTURE + argv)
    jdrift.main()


@pytest.fixture(scope="module")
def jax_runs(tmp_path_factory):
    """The JAX script's bf16 run (its npz) and its int8w / int8-dit reports
    on the gaussian family."""
    out = tmp_path_factory.mktemp("jax_drift")
    mp = pytest.MonkeyPatch()
    try:
        _run_jax_main(["--mode", "bf16", "--out", str(out / "bf16.npz")], mp)
        for mode in ("int8w", "int8-dit"):
            _run_jax_main(["--mode", mode, "--compare", str(out / "bf16.npz"),
                           "--report", str(out / f"{mode}.json")], mp)
    finally:
        mp.undo()
    return out


@pytest.fixture(scope="module")
def port_models():
    """JAX's synthesized tiny weights (gaussian) as the port's modules."""
    cfg = tcfg.tiny_test()
    dit_j, vae_j, _, _ = _jax_trees(jcfg.tiny_test(), "gaussian")
    return lambda: tweights.from_jax_params(cfg, dit_j, vae_j)


def _keys(d) -> dict:
    return {k: _keys(v) for k, v in d.items()} if isinstance(d, dict) else None


@pytest.mark.parametrize("mode", ["int8w", "int8-dit"])
def test_int8_reports_match_jax(jax_runs, port_models, mode):
    ref = json.loads((jax_runs / f"{mode}.json").read_text())
    dit, vae = port_models()
    bf16 = tdrift.run_stages(tdrift.build_pipe("tiny", None, device="cpu", dit=dit, vae=vae),
                             F, H, W)
    dit, vae = port_models()
    pipe = tdrift.build_pipe("tiny", mode, device="cpu", dit=dit, vae=vae)
    ours = tdrift.drift_report(
        tdrift.run_stages(pipe, F, H, W), bf16, preset="tiny", mode=mode,
        weights="gaussian", attention_backend=pipe.attention_backend,
        fixture=[F, H, W], equalized=False, exclude=())
    assert _keys(ours) == _keys(ref)
    for k in ("preset", "mode", "attention_backend", "fixture", "weights", "window_plan",
              "sample_posterior", "equalized", "vae_exclude"):
        assert ours[k] == ref[k], k
    assert ours["rel_err"]["enc_moments"] == ref["rel_err"]["enc_moments"] == 0.0
    assert ref["rel_err"]["dit_x0"] > 0
    np.testing.assert_allclose(ours["rel_err"]["dit_x0"], ref["rel_err"]["dit_x0"],
                               rtol=REL_ERR_RTOL)
    e2e, e2e_ref = ours["end_to_end"], ref["end_to_end"]
    assert abs(e2e["psnr_rgb_vs_bf16_db"] - e2e_ref["psnr_rgb_vs_bf16_db"]) <= PSNR_TOL
    # the bf16 stages themselves agree with JAX's
    jref = np.load(jax_runs / "bf16.npz")
    assert tdrift.rel_err(bf16["x0"], jref["x0"]) < 1e-4
    assert tdrift.psnr_u8(bf16["out_u8"], jref["out_u8"]) > 50


def _tap_autocorr_f64(xf: np.ndarray, reach: int = 2) -> np.ndarray:
    """The JAX package's ``_tap_autocorr`` ([B, F, H, W, C]) in float64."""
    _, F_, H_, W_, _ = xf.shape
    denom = np.mean(np.square(xf)) + 1e-12
    out = np.zeros((2 * reach + 1,) * 3)
    for i, dt in enumerate(range(-reach, reach + 1)):
        for j, dh in enumerate(range(-reach, reach + 1)):
            for k, dw in enumerate(range(-reach, reach + 1)):
                if F_ <= abs(dt) or H_ <= abs(dh) or W_ <= abs(dw):
                    continue
                a = xf[:, max(dt, 0):F_ + min(dt, 0), max(dh, 0):H_ + min(dh, 0),
                       max(dw, 0):W_ + min(dw, 0)]
                b = xf[:, max(-dt, 0):F_ + min(-dt, 0), max(-dh, 0):H_ + min(-dh, 0),
                       max(-dw, 0):W_ + min(-dw, 0)]
                out[i, j, k] = np.mean(a * b) / denom
    return out


def _jax_calibration(vae_tree, cfg, x0: np.ndarray, monkeypatch) -> dict[str, np.ndarray]:
    """JAX's calibration statistics on the script's crops (``calibrate``'s
    taps), its forwards run eagerly with the tap autocorrelation taken in
    float64 on the host: the JAX package's definition without its fp32
    summation (on the CPU its jitted mean drifts by up to ~3e-4 over a
    million-entry activation, where a float64 sum of the same activation is
    within 2e-7 of the port's)."""
    from dove_tpu.models import vae as jvae

    out: dict = {}
    monkeypatch.setattr(jvae, "_tap_autocorr", lambda xf, reach=2: _tap_autocorr_f64(
        np.asarray(xf, np.float64), reach))
    tree = jax.tree.map(jnp.asarray, vae_tree)
    z = jnp.asarray(x0)[:, :3, :16, :24]
    lq = jnp.asarray(tdrift.fixture_clip(F, H, W))[:, :9, :96, :96]
    for fwd, arg in ((lambda q: jvae.decoder_forward(cfg.vae, tree["decoder"], q, None), z),
                     (lambda v: jvae.encoder_forward(cfg.vae, tree["encoder"], v, None), lq)):
        monkeypatch.setattr(jvae, "_CALIB", {})
        fwd(arg)
        out.update({k: np.asarray(v, np.float64) for k, v in jvae._CALIB.items()})
    monkeypatch.setattr(jvae, "_CALIB", None)
    return out


def test_calib_out_matches_jax(jax_runs, port_models, monkeypatch):
    """The calibration npz on the same weights and the same x0 (the JAX
    run's, so the decoder's crop is one input) against JAX's calibration:
    the same keys; amax within 1e-5 relative; tapcorr within 1e-5 of the
    JAX package's statistic taken in float64."""
    x0 = np.load(jax_runs / "bf16.npz")["x0"]
    dit, vae = port_models()
    pipe = tdrift.build_pipe("tiny", None, device="cpu", dit=dit, vae=vae)
    got = tdrift.calibrate_pipe(pipe, x0, F, H, W)
    want = _jax_calibration(_jax_trees(jcfg.tiny_test(), "gaussian")[1], jcfg.tiny_test(),
                            x0, monkeypatch)
    assert sorted(got) == sorted(want)
    assert any(k.startswith("decoder.") for k in got) and any(
        k.startswith("encoder.") for k in got)
    for k, ref in want.items():
        if k.endswith("#tapcorr"):
            np.testing.assert_allclose(got[k], ref, rtol=0, atol=CALIB_TOL, err_msg=k)
        else:
            np.testing.assert_allclose(got[k], ref, rtol=CALIB_TOL,
                                       atol=CALIB_TOL * float(np.abs(ref).max()), err_msg=k)


def test_int8_vae_modes_through_the_entry_point(tmp_path, monkeypatch):
    """bf16 with --calib_out and --attribution, then int8-dit-dec --exclude
    lowres and int8 with that calib, through the port's main on a 64-channel
    VAE: the reports' keys and their telling values."""
    monkeypatch.setitem(tdrift.PRESETS, "tiny", lambda: _wide(tcfg.tiny_test()))
    base = ["--device", "cpu", "--preset", "tiny"] + FIXTURE
    ref, calib = tmp_path / "bf16.npz", tmp_path / "calib.npz"
    attribution = tdrift.main(base + ["--mode", "bf16", "--out", str(ref),
                                      "--calib_out", str(calib), "--attribution"])
    assert attribution["equalized"] and len(attribution["top10"]) == 10
    reports = {}
    for mode, extra in (("int8-dit-dec", ["--exclude", "lowres"]), ("int8", [])):
        path = tmp_path / f"{mode}.json"
        reports[mode] = tdrift.main(base + ["--mode", mode, "--compare", str(ref),
                                            "--calib", str(calib), "--report", str(path)]
                                    + extra)
        assert json.loads(path.read_text()) == reports[mode]
        assert reports[mode]["equalized"]
    dec, full = reports["int8-dit-dec"], reports["int8"]
    assert dec["vae_exclude"] == ["lowres"] and full["vae_exclude"] == []
    assert dec["rel_err"]["enc_moments"] == 0.0  # the encoder stays float
    assert full["rel_err"]["enc_moments"] > 0  # an int8 encoder
    for rep in (dec, full):
        assert 0 < rep["rel_err"]["dit_x0"] < 0.5
        assert 10 < rep["end_to_end"]["psnr_rgb_vs_bf16_db"] < 100
    # the 2B family, refused until ROADMAP A.10 was ported: its report at
    # tiny widths (the JAX script runs the 2B in bf16, and so does the port)
    monkeypatch.setitem(tdrift.PRESETS, "cogvideox-2b", lambda: golden_config("2b"))
    base_2b = ["--device", "cpu", "--preset", "cogvideox-2b"] + FIXTURE
    ref_2b = tmp_path / "bf16_2b.npz"
    assert tdrift.main(base_2b + ["--mode", "bf16", "--out", str(ref_2b)]) is None
    rep = tdrift.main(base_2b + ["--mode", "int8-dit", "--compare", str(ref_2b)])
    assert rep["preset"] == "cogvideox-2b" and rep["rel_err"]["enc_moments"] == 0.0
    assert 0 < rep["rel_err"]["dit_x0"] < 0.5
    assert 10 < rep["end_to_end"]["psnr_y_vs_bf16_db"] < 100  # I420 past tiny
