"""Weight-rounding floor of the int8 decoder under each synthetic family.

    python -m dove_tpu_torch.int8_weight_floor --weights outlier \\
        --calib calib.npz --out weight_floor_outlier.json

The port's counterpart of ``scripts/int8_weight_floor.py``, with its flags
(and ``--device``, the card unless ``cpu``) and its JSON. It synthesizes the
decoder weights the drift runs use (``int8_drift_report.realistic_params``,
VAE seed 2, bf16), quantizes each decoder conv that ``should_quantize_conv``
keeps with the serving quantizer (equalization, the asymmetric scheme's
codes, GPTQ tap rounding where the calib npz has a ``#tapcorr``), and
reports per conv the weight-only relative error in the (equalized) domain
the conv serves in, and the output-domain error under the calibrated tap
Gram H, sqrt(d^T H d / w^T H w): the part of the drift no activation scheme
can remove.
"""

from __future__ import annotations

import argparse
import itertools
import json
import sys
from pathlib import Path

import numpy as np
import torch
from torch import nn

from dove_tpu_torch.int8_drift_report import PRESETS, empty_models, realistic_params
from dove_tpu_torch.ops import quant
from dove_tpu_torch.pipeline import resolve_device


def _tap_gram(tapcorr: np.ndarray, k_dims: tuple[int, ...]) -> np.ndarray:
    """H[t, t'] = c(delta_t - delta_t') over the kernel's taps, row-major."""
    r = (tapcorr.shape[0] - 1) // 2
    taps = list(itertools.product(*[range(k) for k in k_dims]))
    return np.array([[tapcorr[a1 - a2 + r, b1 - b2 + r, c1 - c2 + r]
                      for (a2, b2, c2) in taps] for (a1, b1, c1) in taps], np.float32)


@torch.no_grad()
def conv_floor(conv: nn.Module, amax, tapcorr) -> dict:
    """One conv's weight-only and output-domain relative errors under the
    serving quantizer."""
    q = quant.quantize_conv(
        conv, with_ksum=True,
        calib_amax=None if amax is None else torch.as_tensor(amax),
        tapcorr=None if tapcorr is None else torch.as_tensor(tapcorr))
    w = conv.weight.float()  # [O, I, (kt,) kh, kw]
    if q.equalize_inv is not None:  # serving compares in the equalized domain
        w = w * (1.0 / q.equalize_inv).view((1, -1) + (1,) * (w.ndim - 2))
    cout, cin = w.shape[:2]
    # K4's [taps, Cout, Cin] codes back to the conv's layout, times the scales
    deq = (q.weight_q.float().permute(1, 2, 0).reshape(w.shape)
           * q.kernel_scale.view((-1,) + (1,) * (w.ndim - 1)))
    rel = float(torch.linalg.norm(deq - w) / torch.linalg.norm(w))
    out_rel = None
    if tapcorr is not None and w.ndim == 5:
        H = _tap_gram(np.asarray(tapcorr, np.float32), tuple(w.shape[2:]))
        T = H.shape[0]
        # taps leading, one column per (cin, cout), as the JAX layout flattens
        D = (deq - w).permute(2, 3, 4, 1, 0).reshape(T, -1).cpu().numpy()
        Wf = w.permute(2, 3, 4, 1, 0).reshape(T, -1).cpu().numpy()
        num = float(np.einsum("ti,ts,si->", D, H, D))
        den = float(np.einsum("ti,ts,si->", Wf, H, Wf))
        out_rel = (num / max(den, 1e-30)) ** 0.5
    return {"weight_rel_err": round(rel, 6),
            "output_rel_err": round(out_rel, 6) if out_rel is not None else None}


def weight_floor(vae: nn.Module, calib: dict, family: str) -> dict:
    """The JSON of the JAX script for the decoder of ``vae``."""
    rows = {}
    for name, _, _, _, conv in quant.quantizable_convs(vae, "decoder"):
        rows[name] = conv_floor(conv, calib.get(name), calib.get(f"{name}#tapcorr"))
    wvals = np.array([r["weight_rel_err"] for r in rows.values()])
    ovals = np.array([r["output_rel_err"] for r in rows.values()
                      if r["output_rel_err"] is not None])
    return {
        "weights_family": family,
        "quantizer": ("equalized + GPTQ tap rounding (serving)"
                      if calib else "plain RTN per-channel"),
        "metric": "per-conv weight-only error in the (equalized) domain "
                  "the conv serves in; output_rel_err uses the calibrated "
                  "tap Gram (sqrt(dHd/wHw)) — the error no activation "
                  "scheme can remove",
        "mean_weight_rel_err": round(float(wvals.mean()), 6),
        "median_weight_rel_err": round(float(np.median(wvals)), 6),
        "mean_output_rel_err": (round(float(ovals.mean()), 6) if len(ovals) else None),
        "median_output_rel_err": (round(float(np.median(ovals)), 6)
                                  if len(ovals) else None),
        "per_conv": rows,
    }


def synthetic_vae(preset: str, family: str, device) -> nn.Module:
    """The drift runs' VAE (seed 2) in bf16 on ``device``."""
    cfg = PRESETS[preset]()
    _, vae = empty_models(cfg, torch.bfloat16, torch.device("meta"))
    vae = vae.to_empty(device=device)
    return realistic_params(vae, seed=2, family=family)


def main(argv: list[str] | None = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--weights", default="outlier", choices=["gaussian", "outlier"])
    ap.add_argument("--calib", default=None,
                    help="calib npz (equalization amax + #tapcorr); omit for the "
                         "plain RTN quantizer")
    ap.add_argument("--preset", default="cogvideox1.5-5b", choices=list(PRESETS))
    ap.add_argument("--out", default=None)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    if args.preset == "cogvideox-2b":
        raise NotImplementedError("--preset cogvideox-2b is not ported yet (ROADMAP A.10)")
    vae = synthetic_vae(args.preset, args.weights, resolve_device(args.device))
    calib = {}
    if args.calib:
        loaded = np.load(args.calib)
        calib = {k: loaded[k] for k in loaded.files}
    out = weight_floor(vae, calib, args.weights)
    print(json.dumps({k: v for k, v in out.items() if k != "per_conv"}, indent=2))
    if args.out:
        Path(args.out).write_text(json.dumps(out, indent=2) + "\n")
        print(f"wrote {args.out}", file=sys.stderr)
    return out


if __name__ == "__main__":
    main()
