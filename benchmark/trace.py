"""Reduce a torch.profiler trace of the measured window to what the metrics read.

The window is the span of the harness's ``bench.window`` range. From the
trace's device events (kernels, copies, sets) inside it: the busy time of the
merged intervals, the device seconds of every kernel name and of each kernel
kind (``KERNEL_KINDS``, first match wins), and the idle time, each stretch of
it named by the innermost ``dove.*`` or ``bench.*`` range the host was in.
The exported trace is read once and deleted.
"""

from __future__ import annotations

import json
import os
import tempfile
from pathlib import Path

KERNEL_KINDS = (  # (kind, substrings of lower-case kernel names), first match wins
    ("k2_flash_fwd_qk8", ("flash_fwd_sm90_kernel<__nv_bfloat16, signed char",
                          "flash_fwd_sm90_kernel<__half, signed char")),
    ("k1_flash_fwd", ("flash_fwd_sm90_kernel",)),
    ("k3a_flash_bwd_dq", ("flash_bwd_dq_sm90_kernel",)),
    ("k3b_flash_bwd_dkv", ("flash_bwd_dkv_sm90_kernel",)),
    ("k4_conv3d_w8a8", ("conv3d_taps_sm90_kernel<signed char",
                        "conv3d_taps_sm90_kernel<int8")),
    ("k5_conv3d_bf16", ("conv3d_taps_sm90_kernel<__nv_bfloat16",)),
    ("quant_pack", ("quant_pack_kernel",)),
    ("group_norm", ("rowwisemoments", "group_norm", "groupnorm")),
    ("conv_layout", ("nchwtonhwc", "nhwctonchw")),
    ("conv", ("fprop", "conv", "implicit_gemm", "cudnn")),
    ("int8_gemm", ("i16832gemm", "s8s8", "i8i8", "imma")),
    ("gemm", ("gemm", "nvjet", "cutlass")),
    ("cat_copy_index", ("catarray", "copy", "index", "gather", "memcpy", "memset")),
    ("elementwise", ("elementwise", "reduce", "layer_norm")),
)
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
WINDOW_RANGE = "bench.window"


def kind_of(name: str) -> str:
    low = name.lower()
    return next((k for k, subs in KERNEL_KINDS if any(s in low for s in subs)), "other")


def merged(intervals: list[tuple[float, float]]) -> list[tuple[float, float]]:
    out: list[list[float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def summarize_events(events: list[dict]) -> dict:
    """Trace events (µs) -> {"window_s", "busy_s", "kernels": {name: [s, n]},
    "kinds": {kind: s}, "gaps": {range: s}}; empty without a window range."""
    win = [e for e in events if e.get("name") == WINDOW_RANGE
           and e.get("cat") == "user_annotation" and "dur" in e]
    if not win:
        return {}
    w0 = float(win[0]["ts"])
    w1 = w0 + float(win[0]["dur"])
    spans, kernels, kinds = [], {}, {}
    for e in events:
        if e.get("cat") not in DEVICE_CATS or "dur" not in e:
            continue
        a, b = max(float(e["ts"]), w0), min(float(e["ts"]) + float(e["dur"]), w1)
        if b <= a:
            continue
        spans.append((a, b))
        rec = kernels.setdefault(e["name"], [0.0, 0])
        rec[0] += (b - a) / 1e6
        rec[1] += 1
        k = kind_of(e["name"])
        kinds[k] = kinds.get(k, 0.0) + (b - a) / 1e6
    busy = merged(spans)
    ranges = sorted(
        ((float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"]) for e in events
         if e.get("cat") == "user_annotation" and "dur" in e
         and str(e.get("name", "")).startswith(("dove.", "bench."))),
        key=lambda r: r[0])
    gaps: dict[str, float] = {}
    edges = [w0] + [x for ab in busy for x in ab] + [w1]
    for a, b in zip(edges[0::2], edges[1::2]):
        if b <= a:
            continue
        # split the gap where a range starts or ends; each piece goes to the
        # innermost range around it
        cuts = sorted({a, b} | {x for r in ranges for x in r[:2] if a < x < b})
        for x, y in zip(cuts, cuts[1:]):
            mid = (x + y) / 2
            inside = [r for r in ranges if r[0] <= mid <= r[1]]
            name = min(inside, key=lambda r: r[1] - r[0])[2] if inside else "host"
            gaps[name] = gaps.get(name, 0.0) + (y - x) / 1e6
    return {"window_s": (w1 - w0) / 1e6, "busy_s": sum(b - a for a, b in busy) / 1e6,
            "kernels": kernels, "kinds": kinds, "gaps": gaps}


def summarize(prof) -> dict:
    """Export ``prof``'s trace to a temporary file, summarize it, delete it."""
    fd, path = tempfile.mkstemp(suffix=".json", prefix="bench_trace_")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        events = json.loads(Path(path).read_text())["traceEvents"]
    finally:
        Path(path).unlink(missing_ok=True)
    return summarize_events(events)


def breakdown(summary: dict) -> dict:
    """The ten kernel kinds with the most device time and the ten idle
    ranges with the most idle time, [[name, seconds], ...]."""
    def top(d):
        return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:10]]
    return {"device_ops": top(summary["kinds"]), "idle_gaps": top(summary["gaps"])}


def kernel_seconds(summary: dict, patterns, exclude=()) -> float:
    """Device seconds of the kernels whose lower-case name holds one of
    ``patterns`` and none of ``exclude``."""
    total = 0.0
    for name, (sec, _) in summary.get("kernels", {}).items():
        low = name.lower()
        if any(p in low for p in patterns) and not any(x in low for x in exclude):
            total += sec
    return total
