#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (dove_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one result line each; any failure exits non-zero:

1. device and build: the card's name and power limit, and the nvcc build of
   every kernel under dove_tpu_torch/csrc/;
2. K1 (flash-attention forward) against its plain PyTorch version on the card
   in bf16, bounded and online-softmax forms, at the main path's shape and at
   a ragged length; kernel, plain and SDPA times beside the bound;
3. the staged pipeline at full widths and 2 DiT layers, run once through the
   kernel and once through the plain attention, compared by PSNR;
4. the main path: CogVideoX1.5-5B at full width, all 42 layers, bf16, seeded
   random weights, through DovePipeline.process_frames on a 32-frame
   180x320 clip (720p out), with the kernel's launches counted.

Then one JSON line with the kernels' numbers, the card's name and power
limit, and as the last line {"ok": true, "device": {...}}.

Exits non-zero with no result when no CUDA device is present. It imports
torch, numpy, the standard library and dove_tpu_torch, nothing else.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import time

import numpy as np
import torch

# H100 SXM data sheet (dense): 989 TFLOP/s bf16 tensor cores, 3.35 TB/s HBM.
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES = 3.35e12
# K1 against its plain version, bf16. The absolute bar is that of
# tests/test_flash_attention.py; at the main path's length a typical output is
# ~0.012 (a softmax average over ~S/e keys of unit-variance values), so the
# error is also held relative to the reference: its largest value, and its RMS.
# Dropping one 64-key tile of 18226 moves the output by ~6% RMS.
K1_ABS_TOL = 3e-2  # max |out - ref|
K1_REL_MAX_TOL = 2e-2  # max |out - ref| / max |ref|
K1_REL_RMS_TOL = 1e-2  # rms(out - ref) / rms(ref)
PSNR_BAR_DB = 40.0

# Main-path clip: the bench.py clip, 32 LQ frames of 180x320 -> 720p.
CLIP_FRAMES, CLIP_H, CLIP_W = 32, 180, 320


def log(msg: str) -> None:
    print(msg, flush=True)


def gpu_name_and_limit() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int, warmup: int = 1) -> float:
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def k1_errors(out: torch.Tensor, ref: torch.Tensor) -> dict:
    diff = out.float() - ref.float()
    ref = ref.float()
    max_abs = float(diff.abs().max())
    return dict(
        max_abs=max_abs,
        rel_max=max_abs / float(ref.abs().max()),
        rel_rms=float(diff.square().mean().sqrt() / ref.square().mean().sqrt()),
    )


def k1_within_bars(err: dict) -> bool:
    return (err["max_abs"] <= K1_ABS_TOL and err["rel_max"] <= K1_REL_MAX_TOL
            and err["rel_rms"] <= K1_REL_RMS_TOL)


def main_path_seq_len(cfg) -> int:
    """Joint text+video tokens of the main path's DiT pass."""
    from dove_tpu_torch import tiling

    frames = tiling.next_valid_frames(CLIP_FRAMES + tiling.compute_padding(
        CLIP_FRAMES, CLIP_H, CLIP_W)[0])
    lat = cfg.vae.latent_frames(frames)
    pt = cfg.dit.patch_size_t
    lat += (pt - lat % pt) % pt
    h = CLIP_H * cfg.upscale // cfg.vae.spatial_scale // cfg.dit.patch_size
    w = CLIP_W * cfg.upscale // cfg.vae.spatial_scale // cfg.dit.patch_size
    return cfg.dit.max_text_seq_length + lat // pt * h * w


# ---------------------------------------------------------------------------
# Phase 1: device and build
# ---------------------------------------------------------------------------

def phase_build() -> None:
    from dove_tpu_torch import kernels

    seconds, text = kernels.build("flash_fwd")
    for line in text.splitlines():
        if "registers" in line or "spill" in line or "error" in line:
            log(f"  ptxas flash_fwd: {line.strip()}")
    log(f"phase 1 build: flash_fwd {seconds:.2f}s of nvcc")


# ---------------------------------------------------------------------------
# Phase 2: K1 against its plain version
# ---------------------------------------------------------------------------

def phase_k1(seq_main: int, heads: int) -> dict:
    from dove_tpu_torch.ops import flash_attention as fa

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    worst = 0.0
    timing = None
    for S in (seq_main, 4097, 200):
        q, k, v = (
            torch.randn((1, heads, S, 64), generator=gen, device=dev,
                        dtype=torch.bfloat16)
            for _ in range(3)
        )
        for bounded in (True, False):
            out = fa.flash_attention(q, k, v, bounded_logits=bounded)
            torch.cuda.synchronize()
            ref = fa.flash_attention_plain(q, k, v, bounded_logits=bounded)
            err = k1_errors(out, ref)
            finite = bool(torch.isfinite(out).all())
            log(f"  K1 S={S} bounded={bounded}: max_abs_err {err['max_abs']:.3e}, "
                f"/ max|ref| {err['rel_max']:.3e}, rms err / rms ref "
                f"{err['rel_rms']:.3e} (ref rms "
                f"{float(ref.float().square().mean().sqrt()):.3e}), finite {finite}")
            if not finite or not k1_within_bars(err):
                raise AssertionError(
                    f"K1 disagrees with its plain version: S={S} "
                    f"bounded={bounded} {err}")
            worst = max(worst, err["max_abs"])
        if S == seq_main:
            # the bars must reject a kernel that drops one 64-key tile
            dropped = fa.flash_attention_plain(
                q, k[:, :, 64:].contiguous(), v[:, :, 64:].contiguous(),
                bounded_logits=False)
            miss = k1_errors(dropped, ref)
            log(f"  bar check: one 64-key tile dropped at S={S} gives "
                f"rms err / rms ref {miss['rel_rms']:.3e}, rejected "
                f"{not k1_within_bars(miss)}")
            if k1_within_bars(miss):
                raise AssertionError(f"K1 bars accept a dropped KV tile: {miss}")
            del dropped
            kernel_ms = cuda_ms(
                lambda: fa.flash_attention(q, k, v, bounded_logits=True), 10)
            unb_ms = cuda_ms(
                lambda: fa.flash_attention(q, k, v, bounded_logits=False), 10)
            plain_ms = cuda_ms(
                lambda: fa.flash_attention_plain(q, k, v, bounded_logits=True),
                1, warmup=0)
            library_ms = cuda_ms(
                lambda: torch.nn.functional.scaled_dot_product_attention(
                    q, k, v), 10)
            flops = 4.0 * S * S * 64 * heads
            nbytes = 4 * heads * S * 64 * 2
            bound_ms = max(flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES) * 1e3
            timing = dict(
                kernel_ms=kernel_ms, unbounded_ms=unb_ms, plain_ms=plain_ms,
                library_ms=library_ms, bound_ms=bound_ms,
                bound_by="operations" if flops / PEAK_BF16_FLOPS
                >= nbytes / PEAK_BYTES else "bytes",
                tflops=flops / kernel_ms / 1e9, shape=[1, heads, S, 64],
            )
        del q, k, v
    fa.launches.reset()
    log(f"phase 2 K1: worst max_abs_err {worst:.3e} (bars: abs {K1_ABS_TOL}, "
        f"/ max|ref| {K1_REL_MAX_TOL}, rms ratio {K1_REL_RMS_TOL}); "
        + json.dumps({k: (round(x, 4) if isinstance(x, float) else x)
                      for k, x in timing.items()}))
    return dict(max_abs_err=worst, **timing)


# ---------------------------------------------------------------------------
# Phase 3: the slice through the kernel and through the plain attention
# ---------------------------------------------------------------------------

def _pipeline(cfg, dit, vae, backend: str | None, sample_posterior: bool):
    from dove_tpu_torch.pipeline import DovePipeline

    prompt = torch.zeros((cfg.dit.max_text_seq_length, cfg.dit.text_embed_dim),
                         dtype=torch.bfloat16)
    return DovePipeline(
        config=cfg, dit=dit, vae=vae, prompt_embedding=prompt,
        dtype=torch.bfloat16, device="cuda", attention_backend=backend,
        sample_posterior=sample_posterior, vae_tiling=True, output_uint8=True,
    )


def psnr_u8(a: np.ndarray, b: np.ndarray) -> float:
    mse = float(np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2))
    return float("inf") if mse == 0 else 10.0 * math.log10(255.0**2 / mse)


def phase_kernel_vs_plain_pipeline() -> None:
    """Full widths (48x64 heads, the full VAE), 2 DiT layers, a 9-frame
    96x160 clip: 2146 joint tokens, so the automatic dispatch takes K1."""
    import dataclasses

    from dove_tpu_torch import cogvideox1_5_5b, init_dit_params, init_vae_params
    from dove_tpu_torch.ops import flash_attention as fa

    base = cogvideox1_5_5b()
    cfg = dataclasses.replace(base, dit=dataclasses.replace(base.dit, num_layers=2))
    dit = init_dit_params(cfg.dit, seed=0, device="cuda", dtype=torch.bfloat16)
    vae = init_vae_params(cfg.vae, seed=1, device="cuda", dtype=torch.bfloat16)
    clip = np.random.default_rng(3).uniform(0, 1, (9, 96, 160, 3)).astype(np.float32)
    outs = {}
    for backend in (None, "plain"):
        pipe = _pipeline(cfg, dit, vae, backend, sample_posterior=False)
        fa.launches.reset()
        out = pipe.process_frames(clip, seed=0)
        outs[backend] = (out, fa.launches.count, dict(pipe.stage_times))
    (k_out, k_launch, k_times), (p_out, p_launch, _) = outs[None], outs["plain"]
    if k_out.shape != (9, 384, 640, 3) or k_out.dtype != np.uint8:
        raise AssertionError(f"phase 3 output {k_out.shape} {k_out.dtype}")
    if k_launch != cfg.dit.num_layers or p_launch != 0:
        raise AssertionError(
            f"phase 3 launches: kernel run {k_launch}, plain run {p_launch}")
    psnr = psnr_u8(k_out, p_out)
    max_diff = int(np.abs(k_out.astype(int) - p_out.astype(int)).max())
    log(f"phase 3 kernel vs plain pipeline (2 layers, full width): PSNR "
        f"{psnr:.2f} dB (bar {PSNR_BAR_DB}), max |diff| {max_diff} LSB, "
        f"launches {k_launch}, output std {float(k_out.std()):.2f}, "
        f"stages {json.dumps({k: round(v, 3) for k, v in k_times.items()})}")
    if not psnr >= PSNR_BAR_DB:
        raise AssertionError(f"phase 3 PSNR {psnr} below {PSNR_BAR_DB}")
    del dit, vae
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# Phase 4: the main path, CogVideoX1.5-5B at full width and depth
# ---------------------------------------------------------------------------

def phase_main_path(profile_dir: str | None = None) -> dict:
    from dove_tpu_torch import cogvideox1_5_5b, init_dit_params, init_vae_params
    from dove_tpu_torch.ops import flash_attention as fa

    cfg = cogvideox1_5_5b()
    t0 = time.perf_counter()
    dit = init_dit_params(cfg.dit, seed=0, device="cuda", dtype=torch.bfloat16)
    vae = init_vae_params(cfg.vae, seed=1, device="cuda", dtype=torch.bfloat16)
    pipe = _pipeline(cfg, dit, vae, None, sample_posterior=True)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in dit.parameters())
    clip = np.random.default_rng(4).uniform(
        0, 1, (CLIP_FRAMES, CLIP_H, CLIP_W, 3)).astype(np.float32)

    torch.cuda.reset_peak_memory_stats()
    fa.launches.reset()
    t0 = time.perf_counter()
    out = pipe.process_frames(clip, seed=0)
    wall = time.perf_counter() - t0
    launches = fa.launches.count
    peak = torch.cuda.max_memory_allocated()

    expect = (CLIP_FRAMES, CLIP_H * cfg.upscale, CLIP_W * cfg.upscale, 3)
    if out.shape != expect or out.dtype != np.uint8:
        raise AssertionError(f"main path output {out.shape} {out.dtype}, want {expect}")
    if float(out.std()) == 0.0:
        raise AssertionError("main path output is constant")
    if launches != cfg.dit.num_layers:  # one DiT pass for a <=33-frame clip
        raise AssertionError(f"K1 launches {launches}, want {cfg.dit.num_layers}")
    times = {k: round(v, 3) for k, v in pipe.stage_times.items()}
    log(f"phase 4 main path (5B, {cfg.dit.num_layers} layers, "
        f"{n_params / 1e9:.2f}B DiT params, bf16): output {out.shape} uint8, "
        f"wall {wall:.2f}s, stages {json.dumps(times)}, K1 launches {launches}, "
        f"peak {peak / 2**30:.2f} GiB, weights init {init_s:.1f}s")
    if profile_dir is not None:
        profile_main_path(pipe, clip, profile_dir)
    return dict(launches=launches, stage_s=times, wall_s=wall, peak_bytes=peak)


KERNEL_KINDS = (  # (kind, substrings of CUDA kernel names), first match wins
    ("k1_flash_fwd", ("flash_fwd_kernel",)),
    ("group_norm", ("rowwisemoments", "group_norm", "groupnorm")),
    ("conv_layout", ("nchwtonhwc", "nhwctonchw")),
    ("conv", ("fprop", "conv", "implicit_gemm", "cudnn")),
    ("gemm", ("gemm", "nvjet", "cutlass")),
    ("cat_copy_index", ("catarray", "copy", "index", "gather", "memcpy", "memset")),
    ("elementwise", ("elementwise", "reduce", "layer_norm")),
)


def _merged_busy(intervals: list[tuple[float, float]]) -> float:
    busy, end = 0.0, float("-inf")
    for a, b in sorted(intervals):
        if b > end:
            busy += b - max(a, end)
            end = b
    return busy


def profile_main_path(pipe, clip: np.ndarray, out_dir: str) -> None:
    """A warm unprofiled run for steady-state stage times, then one run under
    torch.profiler. From the exported trace's kernel events: the device's
    busy and idle share, device time by kernel kind, and busy time inside
    each pipeline stage's range ("dove.enc", ...). The key_averages table
    goes to <out_dir>/main_path_profile.txt."""
    from pathlib import Path

    from torch.profiler import ProfilerActivity, profile

    t0 = time.perf_counter()
    pipe.process_frames(clip, seed=0)
    warm = time.perf_counter() - t0
    warm_stages = {k: round(v, 3) for k, v in pipe.stage_times.items()}
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        pipe.process_frames(clip, seed=0)
        prof_wall = time.perf_counter() - t0
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    (out / "main_path_profile.txt").write_text(
        prof.key_averages().table(sort_by="self_device_time_total", row_limit=40))
    trace_path = out / "main_path_trace.json"
    prof.export_chrome_trace(str(trace_path))
    events = json.loads(trace_path.read_text())["traceEvents"]
    trace_path.unlink()  # tens of MB; the summary below is what is kept
    kernels = [e for e in events
               if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
    spans = [(float(e["ts"]), float(e["ts"]) + float(e["dur"])) for e in kernels]
    window = max(b for _, b in spans) - min(a for a, _ in spans)
    busy = _merged_busy(spans)
    by_kind: dict[str, float] = {}
    for e in kernels:
        name = e["name"].lower()
        kind = next((k for k, subs in KERNEL_KINDS if any(x in name for x in subs)),
                    "other")
        by_kind[kind] = by_kind.get(kind, 0.0) + float(e["dur"])
    by_stage = {}
    for e in events:
        if e.get("cat") == "gpu_user_annotation" and e["name"].startswith("dove."):
            a, b = float(e["ts"]), float(e["ts"]) + float(e["dur"])
            inside = [(max(x, a), min(y, b)) for x, y in spans if y > a and x < b]
            by_stage[e["name"]] = {"span_s": round((b - a) / 1e6, 3),
                                   "busy_s": round(_merged_busy(inside) / 1e6, 3)}
    log(f"phase 4 profile: warm wall {warm:.2f}s stages {json.dumps(warm_stages)}; "
        f"profiled wall {prof_wall:.2f}s, {len(kernels)} kernels, device busy "
        f"{busy / 1e6:.3f}s of a {window / 1e6:.3f}s kernel window "
        f"(idle {100 * (1 - busy / window):.1f}%), by stage {json.dumps(by_stage)}, "
        "by kind (s) " + json.dumps(
            {k: round(v / 1e6, 3) for k, v in sorted(by_kind.items(),
                                                     key=lambda kv: -kv[1])}))


def main(argv: list[str] | None = None) -> int:
    import argparse

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument(
        "--profile", metavar="DIR", default=None,
        help="after phase 4, time a warm run and profile one more; write the "
             "top kernels to DIR/main_path_profile.txt")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing to run", file=sys.stderr)
        return 1
    from dove_tpu_torch import cogvideox1_5_5b

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = gpu_name_and_limit()
    log(f"phase 1 device: {card}; torch {torch.__version__} cuda "
        f"{torch.version.cuda}")
    phase_build()
    cfg = cogvideox1_5_5b()
    k1 = phase_k1(main_path_seq_len(cfg), cfg.dit.num_attention_heads)
    phase_kernel_vs_plain_pipeline()
    main_path = phase_main_path(args.profile)

    kernels = [{
        "name": "flash_fwd_bf16",
        "route": "cuda",
        "source": "dove_tpu_torch/csrc/flash_fwd.cu",
        "replaces": "dove_tpu/ops/pallas/flash_attention.py:75",
        "launches": main_path["launches"],
        "max_abs_err": k1["max_abs_err"],
        "ms": k1["kernel_ms"],
        "plain_ms": k1["plain_ms"],
        "bound_ms": k1["bound_ms"],
        "bound_by": k1["bound_by"],
        "library_ms": k1["library_ms"],
    }]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
