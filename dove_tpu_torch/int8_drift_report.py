"""Quantized-against-bf16 serving drift at full model scale, on the card.

    python -m dove_tpu_torch.int8_drift_report --mode bf16 --out bf16.npz \\
        --calib_out calib.npz
    python -m dove_tpu_torch.int8_drift_report --mode int8-dit \\
        --compare bf16.npz --report int8_dit.json

The port's counterpart of ``scripts/int8_drift_report.py``, with its function
names, flags and report keys (``--device`` in place of ``--cpu``; the entry
point runs on the card unless ``--device cpu``):

  1. synthesizes realistic-magnitude weights from a seed, tensor by tensor
     on the device at the model dtype, in one of two families:
     ``gaussian`` (fan-in-scaled normals) or ``outlier`` (Student-t(4)
     entries times log-normal(0, 0.6^2) per-output-channel gains, unit total
     variance: a conservative proxy of a trained checkpoint's outlier
     channels);
  2. runs the staged pipeline's three stages (``enc_all``, ``dit_step``,
     ``dec_all``) on a fixed fixture clip and dumps the stage outputs
     (moments, x0 latent, uint8 pixels) to an npz;
  3. in a second run with ``--mode <quantized> --compare <bf16.npz>``
     reports each stage's relative error and the end-to-end PSNR of the
     uint8 output against bf16, as JSON.

Synthesis follows the JAX script leaf for leaf, in the JAX package's layout
(``realistic_params``): a kernel's fan-in is the product of all its JAX dims
but the last, the outlier gains lie on the last (output) axis, and the DiT's
blocks are one leaf stacked over the layers, so their fan-in includes the
layer count, their gains are shared by every layer, and their per-layer
vectors (norm scales, biases) are drawn like kernels. Only the JAX tree's
1-D leaves are ones (scales) or zeros (biases). The port's tensors are in
diffusers layout, so each tensor's JAX leaf, shape and name come from
inverting the converter's layout map (``weights._torch_layout``) and its
renames. Torch's draws cannot equal JAX's: runs compare weight families, not
draws (tests carry JAX's draws across with ``weights.from_jax_params``).

A quantized run that is not ``tiny`` is forced onto the bf16 mode's VAE
window plan ``(2, (32, 32), (28, 28))``: GroupNorm takes its statistics per
window, so with random weights the window geometry alone moves the output
(22.5 dB in the JAX script's header); the forced plan isolates quantization.
Each run builds its weights anew from the seed: ``quantize_dit`` and
``quantize_vae`` replace modules in place.
"""

from __future__ import annotations

import argparse
import json
import math
import sys
import time
from pathlib import Path

import numpy as np
import torch
from torch import nn

from dove_tpu_torch import config as cfg_mod
from dove_tpu_torch.models import vae as vae_mod
from dove_tpu_torch.models.dit import CogVideoXTransformer3D
from dove_tpu_torch.models.vae import AutoencoderKLCogVideoX
from dove_tpu_torch.pipeline import QUANTIZE_MODES, DovePipeline, resolve_device

PRESETS = {
    "tiny": cfg_mod.tiny_test,
    "cogvideox1.5-5b": cfg_mod.cogvideox1_5_5b,
    "cogvideox-2b": cfg_mod.cogvideox_2b,
}
MODES = ("bf16",) + QUANTIZE_MODES
# the bf16 mode's window plan (blend, encode max, decode max), in latents
BF16_WINDOW_PLAN = (2, (32, 32), (28, 28))

# the converter's renames (weights._DIT_RENAME, _VAE_RENAME), inverted
_INVERSE_RENAMES = (("to_out.0", "to_out"), ("net.0.proj", "net_0_proj"),
                    ("net.2", "net_2"), ("downsamplers.0", "downsampler"),
                    ("upsamplers.0", "upsampler"))
_CAUSAL_CONVS = {"conv_in", "conv_out", "conv1", "conv2", "conv_y", "conv_b"}


def jax_leaf(name: str, ndim: int) -> tuple[str, bool]:
    """A port tensor's leaf in the JAX package's tree -> (its lowercase key
    path as ``jax.tree_util.keystr`` writes it, whether it is a slice of a
    leaf stacked over the DiT's layers). ``ndim`` is the torch tensor's:
    "weight" is a "kernel" from two dims up, else a norm's "scale"."""
    stacked = name.startswith("transformer_blocks.")
    if stacked:
        name = "blocks." + name.split(".", 2)[2]
    for ours, theirs in _INVERSE_RENAMES:
        name = name.replace(ours, theirs)
    toks = name.split(".")
    keep = []
    for i, t in enumerate(toks):
        if t == "conv" and i > 0 and toks[i - 1] in _CAUSAL_CONVS:
            continue  # a causal conv's inner nn.Conv3d
        keep.append(t)
    if keep[-1] == "weight":
        keep[-1] = "kernel" if ndim >= 2 else "scale"
    path = "".join(f"[{t}]" if t.isdigit() else f"['{t}']" for t in keep)
    return path.lower(), stacked


def jax_shape(shape: torch.Size, stacked: bool, n_layers: int,
              name: str = "") -> tuple[int, ...]:
    """The JAX leaf's shape: the converter's layout map inverted (a linear
    [out, in] is [in, out]; a conv [O, I, *k] is [*k, I, O]; the 2B's
    ``pos_embedding`` [1, L, dim] is not a kernel and keeps its own), with
    the layer axis in front for a stacked leaf."""
    s = tuple(shape)
    if len(s) >= 2 and not name.endswith("pos_embedding"):
        s = s[2:] + (s[1], s[0])
    return ((n_layers,) + s) if stacked else s


def _ones_leaf(path: str, ndim: int) -> bool:
    """The JAX script's rule for its 1-D leaves: multiplicative ones."""
    return any(t in path for t in ("scale", "gamma", "weight_norm")) or (
        path.endswith("['weight']") and ndim == 1)


def _t4(gen: torch.Generator, shape, dtype, device) -> torch.Tensor:
    """Student-t(4) as Z / sqrt(chi2_4 / 4), chi2_4 = -2 ln(U1 U2): the JAX
    script's closed form (normals at the model dtype, uniforms in fp32 on
    [1e-7, 1))."""
    z = torch.randn(shape, generator=gen, device=device, dtype=torch.float32).to(dtype)
    u1 = 1e-7 + (1.0 - 1e-7) * torch.rand(shape, generator=gen, device=device)
    u2 = 1e-7 + (1.0 - 1e-7) * torch.rand(shape, generator=gen, device=device)
    inv = torch.rsqrt(-0.5 * (torch.log(u1) + torch.log(u2)))
    return z * inv.to(dtype)


@torch.no_grad()
def realistic_params(model: nn.Module, seed: int, family: str = "gaussian") -> nn.Module:
    """Fill ``model`` (a DiT or a VAE, materialized on its device) in place
    with the JAX script's synthetic statistics, leaf by leaf, at each
    tensor's own dtype, and return it.

    family="gaussian": N(0, fan_in^-0.5); "outlier": Student-t(4) entries
    scaled to variance 1 / fan_in, times per-output-channel log-normal gains
    normalized to unit mean square (shared by the layers of a stacked leaf).
    JAX's 1-D leaves: ones for scales, zeros for biases. The 2B's sincos
    ``pos_embedding`` [1, L, dim] is a 3-D leaf of the JAX tree, so the JAX
    script draws it like a kernel (fan-in L, gains on dim), as here."""
    if family not in ("gaussian", "outlier"):
        raise ValueError(f"unknown weights family: {family!r}")
    blocks = getattr(model, "transformer_blocks", None)
    n_layers = len(blocks) if blocks is not None else 0
    state = model.state_dict()
    leaves: dict[str, list[torch.Tensor]] = {}
    meta: dict[str, tuple[int, ...]] = {}
    for name, t in state.items():
        path, stacked = jax_leaf(name, t.ndim)
        leaves.setdefault(path, []).append(t)
        meta[path] = jax_shape(t.shape, stacked, n_layers, name)
    for index, (path, tensors) in enumerate(leaves.items()):
        shape = meta[path]
        first = tensors[0]
        if len(shape) <= 1:
            for t in tensors:
                t.fill_(1.0 if _ones_leaf(path, len(shape)) else 0.0)
            continue
        gen = torch.Generator(device=first.device).manual_seed(
            int(np.random.SeedSequence([seed, index]).generate_state(1)[0]))
        fan_in = math.prod(shape[:-1])
        dtype, device = first.dtype, first.device
        gains = None
        if family == "outlier":
            g = torch.exp(0.6 * torch.randn(shape[-1], generator=gen, device=device))
            gains = (g / torch.sqrt(torch.mean(g * g))).to(dtype)
        for t in tensors:  # one per layer of a stacked leaf
            if gains is None:
                arr = (torch.randn(t.shape, generator=gen, device=device,
                                   dtype=torch.float32).to(dtype)
                       * torch.tensor(fan_in ** -0.5, dtype=dtype))
            else:
                arr = (_t4(gen, t.shape, dtype, device)
                       * torch.tensor((fan_in * 2.0) ** -0.5, dtype=dtype))
                # on the output axis: a torch kernel's first, the table's last
                axis = -1 if path.endswith("['pos_embedding']") else 0
                arr = arr * gains.view([-1 if d == axis % t.ndim else 1
                                        for d in range(t.ndim)])
            t.copy_(arr)
    return model


def empty_models(cfg, dtype: torch.dtype, device) -> tuple[nn.Module, nn.Module]:
    """A DiT and a VAE with uninitialized storage on ``device``."""
    with torch.device("meta"):
        dit = CogVideoXTransformer3D(cfg.dit, dtype=dtype)
        vae = AutoencoderKLCogVideoX(cfg.vae, dtype=dtype)
    return dit.to_empty(device=device), vae.to_empty(device=device)


def compact_hbm(pipe: DovePipeline) -> None:
    """Round-trip the weights through the host (numerically a no-op), as the
    JAX script's option does; then release the allocator's cached blocks."""
    t0 = time.time()
    for name in ("dit", "vae"):
        setattr(pipe, name, getattr(pipe, name).to("cpu").to(pipe.device))
    pipe.prompt_embedding = pipe.prompt_embedding.cpu().to(pipe.device)
    if pipe.device.type == "cuda":
        torch.cuda.empty_cache()
        in_use = torch.cuda.memory_allocated(pipe.device)
    else:
        in_use = None
    print(f"compact_hbm: {time.time() - t0:.0f}s, bytes_in_use={in_use}",
          file=sys.stderr)


def build_pipe(preset: str, quantize: str | None, weights: str = "gaussian",
               attention: str | None = None, vae_calib: dict | None = None,
               vae_exclude: tuple[str, ...] = (), device=None,
               dit: nn.Module | None = None, vae: nn.Module | None = None
               ) -> DovePipeline:
    """The drift run's pipeline: staged (``vae_tiling``), uint8 out, packed
    I420 but at ``tiny``, the posterior mean, the quantize mode with its
    calibration and exclusions; a quantized run past ``tiny`` takes the bf16
    window plan. The weights are synthesized (DiT seed 1, VAE seed 2) unless
    ``dit`` / ``vae`` are given."""
    cfg = PRESETS[preset]()
    dtype = torch.float32 if preset == "tiny" else torch.bfloat16
    device = resolve_device(device)
    if dit is None or vae is None:
        new_dit, new_vae = empty_models(cfg, dtype, device)
        if dit is None:
            dit = realistic_params(new_dit, seed=1, family=weights)
        if vae is None:
            vae = realistic_params(new_vae, seed=2, family=weights)
    pipe = DovePipeline(
        config=cfg, dit=dit, vae=vae,
        prompt_embedding=torch.zeros(
            (cfg.dit.max_text_seq_length, cfg.dit.text_embed_dim), dtype=dtype),
        dtype=dtype, device=device, attention_backend=attention,
        vae_tiling=True, output_uint8=True,
        # the headline clip's packed I420 (bench.py)
        output_i420=preset != "tiny",
        quantize=quantize, vae_calib=vae_calib, vae_exclude=tuple(vae_exclude),
        sample_posterior=False,  # deterministic: drift only, no sampling
    )
    if quantize and preset != "tiny":
        # the int8 modes plan larger VAE windows; with untrained weights the
        # window plan alone moves the output, so take the bf16 mode's plan
        pipe._window_budget = lambda: BF16_WINDOW_PLAN
    return pipe


def fixture_clip(frames: int, height: int, width: int) -> np.ndarray:
    """The fixed LQ clip [1, F, H, W, 3] in [-1, 1] (``default_rng(0)``)."""
    rng = np.random.default_rng(0)
    return rng.random((1, frames, height, width, 3), np.float32) * 2.0 - 1.0


@torch.inference_mode()
def run_stages(pipe: DovePipeline, frames: int, height: int, width: int) -> dict:
    """enc_all -> dit_step -> dec_all on the fixture clip, each stage ended
    by a synchronisation -> {moments, x0, out_u8, seconds}."""
    lq = torch.as_tensor(fixture_clip(frames, height, width)).to(pipe.device, pipe.dtype)
    gen = torch.Generator(device=pipe.device).manual_seed(42)
    pipe._barrier()
    t0 = time.time()
    moments = pipe.enc_all(lq)
    pipe._barrier()
    z = pipe.dit_step(moments, gen)
    pipe._barrier()
    out = pipe.dec_all(z).cpu().numpy()
    dt = time.time() - t0
    return {
        "moments": moments.float().cpu().numpy(),
        "x0": z.float().cpu().numpy(),
        "out_u8": out,
        "seconds": np.float64(dt),
    }


def rel_err(a: np.ndarray, b: np.ndarray) -> float:
    num = np.linalg.norm((a - b).ravel().astype(np.float64))
    den = max(np.linalg.norm(b.ravel().astype(np.float64)), 1e-12)
    return float(num / den)


def psnr_u8(a: np.ndarray, b: np.ndarray) -> float:
    mse = np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2)
    return float(100.0 if mse == 0 else 10.0 * np.log10(255.0**2 / mse))


def _calib_inputs(pipe: DovePipeline, x0: np.ndarray, frames: int, height: int,
                  width: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The JAX script's calibration crops, NCDHW: the decoder sees x0's
    [:, :3, :16, :24], the encoder the fixture's [:, :9, :96, :96]."""
    z = torch.as_tensor(x0).to(pipe.device, pipe.dtype)[:, :3, :16, :24]
    lq = torch.as_tensor(fixture_clip(frames, height, width)).to(
        pipe.device, pipe.dtype)[:, :9, :96, :96]
    return z.permute(0, 4, 1, 2, 3), lq.permute(0, 4, 1, 2, 3)


def calibrate_pipe(pipe: DovePipeline, x0: np.ndarray, frames: int, height: int,
                   width: int) -> dict[str, np.ndarray]:
    """Per-conv activation amax and tap autocorrelation on the calibration
    crops: the npz that ``--calib`` and the CLI's ``--vae_calib`` read."""
    cfg = pipe.config.vae
    z, lq = _calib_inputs(pipe, x0, frames, height, width)
    _, dec_stats = vae_mod.calibrate(
        lambda q: vae_mod.decoder_forward(cfg, pipe.vae.decoder, q, None), z)
    _, enc_stats = vae_mod.calibrate(
        lambda v: vae_mod.encoder_forward(cfg, pipe.vae.encoder, v, None), lq)
    return {k: v.float().cpu().numpy() for k, v in {**enc_stats, **dec_stats}.items()}


def attribution_ranking(pipe: DovePipeline, x0: np.ndarray, frames: int, height: int,
                        width: int, calib: dict | None) -> list[tuple[str, float]]:
    """Every quantizable VAE conv by its local int8 output error on the
    calibration crops (``vae.attribute_quant_error``), worst first."""
    cfg = pipe.config.vae
    z, lq = _calib_inputs(pipe, x0, frames, height, width)
    calib_t = None if calib is None else {k: torch.as_tensor(v) for k, v in calib.items()}
    _, dec_err = vae_mod.attribute_quant_error(
        lambda q: vae_mod.decoder_forward(cfg, pipe.vae.decoder, q, None), z,
        calib=calib_t)
    _, enc_err = vae_mod.attribute_quant_error(
        lambda v: vae_mod.encoder_forward(cfg, pipe.vae.encoder, v, None), lq,
        calib=calib_t)
    return sorted(
        ((name, float(np.sqrt(float(e) / max(float(n), 1e-30))))
         for name, (e, n) in {**enc_err, **dec_err}.items()),
        key=lambda kv: -kv[1])


def drift_report(stages: dict, ref, *, preset: str, mode: str, weights: str,
                 attention_backend: str | None, fixture: list[int], equalized: bool,
                 exclude: tuple[str, ...]) -> dict:
    """The JAX script's report (the same keys) of a run against the bf16
    reference's stage outputs."""
    out, ref_out = stages["out_u8"], ref["out_u8"]
    if out.ndim == 4:  # packed I420 [B, F, H*3//2, W]: Y alone, and all planes
        psnr = {
            "psnr_y_vs_bf16_db": psnr_u8(out[:, :, : out.shape[2] * 2 // 3],
                                         ref_out[:, :, : ref_out.shape[2] * 2 // 3]),
            "psnr_i420_packed_db": psnr_u8(out, ref_out),
        }
    else:
        psnr = {"psnr_rgb_vs_bf16_db": psnr_u8(out, ref_out)}
    return {
        "preset": preset,
        "mode": mode,
        "attention_backend": attention_backend,
        "fixture": fixture,
        "weights": (
            "synthetic fan-in-scaled normals (see script header)"
            if weights == "gaussian" else
            "synthetic outlier family: Student-t(4) entries x "
            "log-normal(0.6) per-channel gains — conservative "
            "trained-checkpoint proxy (see script header)"
        ),
        "window_plan": (
            "int8 run forced onto the bf16 VAE window budget — isolates "
            "quantization from per-window GroupNorm geometry (script "
            "header caveat 2)"
            if preset != "tiny" else "single window (tiny)"
        ),
        "sample_posterior": False,
        "equalized": equalized,
        "vae_exclude": list(exclude),
        "rel_err": {
            "enc_moments": rel_err(stages["moments"], ref["moments"]),
            "dit_x0": rel_err(stages["x0"], ref["x0"]),
        },
        "end_to_end": {
            **psnr,
            "max_abs_u8": int(np.abs(out.astype(np.int32) - ref_out.astype(np.int32)).max()),
            "mean_abs_u8": float(np.abs(out.astype(np.float64)
                                        - ref_out.astype(np.float64)).mean()),
        },
    }


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--mode", required=True, choices=list(MODES))
    ap.add_argument("--weights", default="gaussian", choices=["gaussian", "outlier"],
                    help="synthetic weight family (outlier = conservative "
                         "trained-checkpoint proxy)")
    ap.add_argument("--attention", default=None, choices=["flash", "flash-qk8"],
                    help="force the attention backend (flash = bf16 attention "
                         "inside a quantized run, isolating the int8 Q K^T "
                         "attention's share of the DiT drift)")
    ap.add_argument("--preset", default="cogvideox1.5-5b", choices=list(PRESETS))
    ap.add_argument("--frames", type=int, default=33)
    ap.add_argument("--height", type=int, default=180)
    ap.add_argument("--width", type=int, default=320)
    ap.add_argument("--out", type=str, default=None,
                    help="npz dump of stage outputs (the bf16 reference run)")
    ap.add_argument("--compare", type=str, default=None,
                    help="bf16 npz to compare against (a quantized run)")
    ap.add_argument("--report", type=str, default=None)
    ap.add_argument("--calib_out", type=str, default=None,
                    help="(bf16 run) write per-conv activation amax and tap "
                         "autocorrelation for equalization and GPTQ rounding")
    ap.add_argument("--calib", type=str, default=None,
                    help="(quantized run) equalize and GPTQ-round the VAE "
                         "convs with these calibration stats")
    ap.add_argument("--exclude", type=str, default=None,
                    help="comma-separated conv names to keep in bf16 "
                         "(\"lowres\": the decoder's low-resolution levels)")
    ap.add_argument("--attribution", action="store_true",
                    help="(bf16 run) rank every quantizable VAE conv by its "
                         "local int8 output error; with --calib (or "
                         "--calib_out) under the equalized quantizer")
    ap.add_argument("--compact_hbm", action="store_true",
                    help="round-trip the weights through the host after the build")
    return ap


def main(argv: list[str] | None = None) -> dict | None:
    args = build_parser().parse_args(argv)
    vae_calib = None
    if args.calib:
        loaded = np.load(args.calib)
        vae_calib = {k: torch.as_tensor(loaded[k]) for k in loaded.files}
        print(f"equalizing with {len(vae_calib)} calibrated convs ({args.calib})",
              file=sys.stderr)
    exclude = tuple(n for n in (args.exclude or "").split(",") if n.strip())
    pipe = build_pipe(args.preset, None if args.mode == "bf16" else args.mode,
                      weights=args.weights, attention=args.attention,
                      vae_calib=vae_calib, vae_exclude=exclude, device=args.device)
    if args.compact_hbm:
        compact_hbm(pipe)
    stages = run_stages(pipe, args.frames, args.height, args.width)
    print(f"{args.mode} stages done in {float(stages['seconds']):.1f}s", file=sys.stderr)
    if args.out:
        np.savez_compressed(args.out, **stages)
        print(f"wrote {args.out}", file=sys.stderr)

    calib_np = None if vae_calib is None else {
        k: v.float().cpu().numpy() for k, v in vae_calib.items()}
    if args.calib_out:
        if args.mode != "bf16":
            raise SystemExit("--calib_out requires --mode bf16")
        calib = calibrate_pipe(pipe, stages["x0"], args.frames, args.height, args.width)
        np.savez_compressed(args.calib_out, **calib)
        print(f"wrote {args.calib_out} ({len(calib)} convs)", file=sys.stderr)
        if args.attribution and calib_np is None:
            calib_np = calib  # rank under the quantizer the stats were taken for
            print("attribution will use the freshly captured calib", file=sys.stderr)

    if args.attribution:
        if args.mode != "bf16":
            raise SystemExit("--attribution requires --mode bf16")
        ranking = attribution_ranking(pipe, stages["x0"], args.frames, args.height,
                                      args.width, calib_np)
        attribution = {
            "preset": args.preset,
            "weights_family": args.weights,
            "equalized": bool(calib_np),
            "metric": "per-layer LOCAL output rel-err of the int8 conv vs "
                      "bf16 on the same input (first-order attribution)",
            "top10": [{"layer": k, "rel_err": round(v, 6)} for k, v in ranking[:10]],
            "rel_err_by_layer": {k: round(v, 6) for k, v in ranking},
        }
        print(json.dumps({"attribution_top10": attribution["top10"]}, indent=2))
        if args.report and not args.compare:
            Path(args.report).write_text(json.dumps(attribution, indent=2))
            print(f"wrote {args.report}", file=sys.stderr)
        if not args.compare:
            return attribution

    if args.compare:
        ref = np.load(args.compare)
        if ref["out_u8"].shape != stages["out_u8"].shape:
            raise SystemExit(
                f"--compare npz output shape {ref['out_u8'].shape} != this "
                f"run's {stages['out_u8'].shape} — the reference was dumped "
                "with different fixture/output settings; re-dump with "
                "--mode bf16 using the same flags")
        report = drift_report(
            stages, ref, preset=args.preset, mode=args.mode, weights=args.weights,
            attention_backend=pipe.attention_backend,
            fixture=[args.frames, args.height, args.width],
            equalized=bool(vae_calib), exclude=exclude)
        print(json.dumps(report, indent=2))
        if args.report:
            Path(args.report).write_text(json.dumps(report, indent=2))
        return report
    return None


if __name__ == "__main__":
    main()
