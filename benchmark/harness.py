"""The benchmark's run: set-up, the measured window, the metrics, the check.

Everything a cell needs is found by name, so that a later change adds a
configuration, a traffic mix, a cell, a driver or a metric as new files:

  * ``configs/<config>.json``: the model as it is run (sizes, dtype, source);
  * ``traffic/<traffic>.json``: a traffic mix, the parameters its driver reads,
    with ``kind`` naming the driver;
  * ``workloads/<cell>.json``: one cell: its configuration, traffic mix, and
    the limits of the numbers that decide ``correct``;
  * ``drivers/<kind>.py``: builds the program for a cell and warms it up
    (``Job``), runs one unit of work (a clip, a step) per ``step`` call, and
    in ``check`` frees the program and compares with the plain reference;
  * ``metrics/<metric>.py``: a per-layer metric's reader, ``read(ctx)``,
    which returns None where it finds nothing to read.

The end-to-end metrics are the harness's own: the driver's rate over the
window (``RATE``: units of work done / window seconds), ``peak_gib`` (the
device's allocation peak over the window) and ``setup_s`` (process start to
the window's start).
"""

from __future__ import annotations

import dataclasses
import gc
import importlib.util
import json
import math
import sys
import time
from pathlib import Path
from types import ModuleType

import torch
from torch.profiler import ProfilerActivity, profile, record_function

from benchmark import trace as trace_mod

ROOT = Path(__file__).resolve().parent
REPO = ROOT.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "dove_tpu")


def find(roots, folder: str, name: str, suffix: str) -> Path:
    for root in roots:
        path = Path(root) / folder / f"{name}{suffix}"
        if path.is_file():
            return path
    raise FileNotFoundError(f"no {folder}/{name}{suffix} under {[str(r) for r in roots]}")


def load_json(roots, folder: str, name: str) -> dict:
    return json.loads(find(roots, folder, name, ".json").read_text())


def load_module(roots, folder: str, name: str) -> ModuleType:
    path = find(roots, folder, name, ".py")
    spec = importlib.util.spec_from_file_location(f"benchmark_{folder}_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({m for m in sys.modules if m.split(".")[0] in FORBIDDEN})


@dataclasses.dataclass
class Cell:
    """What a driver and a metric see of a cell."""

    name: str
    seed: int
    device: torch.device
    config: dict  # configs/<config>.json
    mix: dict  # traffic/<traffic>.json
    limits: dict  # name -> limit of each number compared
    variant: str | None = None  # a control path of the program (never in a timed run)
    fault: str | None = None  # a fault planted for the harness's tests
    warm: bool = True  # run a warm unit in set-up (readings of the check skip it)
    seconds: float = 0.0  # the window asked for, so set-up can make its inputs

    @property
    def dtype(self) -> torch.dtype:
        return getattr(torch, self.config["dtype"])


@dataclasses.dataclass
class Window:
    """What the per-layer readers take: the cell, each unit's spans (stage
    seconds), the window's length, and the trace's summary (traced runs)."""

    cell: Cell
    units: list[dict]
    seconds: float
    trace: dict


def make_cell(roots, name: str, seed: int, device, variant=None, fault=None,
              warm: bool = True, seconds: float = 0.0) -> tuple[Cell, dict]:
    spec = load_json(roots, "workloads", name)
    cell = Cell(name=name, seed=seed, device=torch.device(device),
                config=load_json(roots, "configs", spec["config"]),
                mix=load_json(roots, "traffic", spec["traffic"]),
                limits=dict(spec.get("limits", {})), variant=variant, fault=fault,
                warm=warm, seconds=seconds)
    return cell, spec


def metrics_for(bench: dict, section: str, cell: str) -> list[dict]:
    return [m for m in bench[section] if cell in m.get("workloads", [cell])]


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def measure(job, seconds: float, device: torch.device, traced: bool) -> tuple[list[dict], float, dict]:
    """Whole units back to back, closed loop: after each, stop when one more
    unit as long as the last would end past ``seconds``. -> (units, window
    seconds, trace summary)."""
    units: list[dict] = []
    prof = None
    if traced:
        acts = [ProfilerActivity.CPU]
        if device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        prof = profile(activities=acts)
        prof.__enter__()
    try:
        with record_function(trace_mod.WINDOW_RANGE):
            sync(device)
            t0 = last = time.perf_counter()
            while True:
                with record_function("bench.unit"):
                    rec = job.step(len(units))
                sync(device)
                now = time.perf_counter()
                rec["wall"] = now - last
                units.append(rec)
                if now - t0 + (now - last) > seconds:
                    break
                last = now
            window = now - t0
    finally:
        if prof is not None:
            prof.__exit__(None, None, None)
    summary = trace_mod.summarize(prof) if prof is not None else {}
    return units, window, summary


def run(name: str, seed: int, seconds: float, traced: bool, device="cuda",
        t_start: float | None = None, roots=(ROOT,), bench: dict | None = None,
        variant: str | None = None, fault: str | None = None, warm: bool = True) -> dict:
    """One run of cell ``name`` -> the result line's dict (without printing)."""
    t_start = time.time() if t_start is None else t_start
    roots = tuple(roots)
    if bench is None:
        bench = json.loads((REPO / "BENCHMARK.json").read_text())
    cell, _ = make_cell(roots, name, seed, device, variant, fault, warm, seconds)
    driver = load_module(roots, "drivers", cell.mix["kind"])
    job = driver.Job(cell)
    sync(cell.device)
    setup_s = time.time() - t_start
    if cell.device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(cell.device)
    units, window, summary = measure(job, seconds, cell.device, traced)
    peak = (torch.cuda.max_memory_allocated(cell.device)
            if cell.device.type == "cuda" else 0)
    done = sum(u["units"] for u in units)
    out = {"correct": False, "attempted": len(units), "failed": 0}
    if traced:
        ctx = Window(cell, units, window, summary)
        metrics = {}
        for m in metrics_for(bench, "per_layer", name):
            value = load_module(roots, "metrics", m["name"]).read(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        values = {driver.RATE: done / window, "peak_gib": peak / 2**30, "setup_s": setup_s}
        metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                   for m in metrics_for(bench, "end_to_end", name) if m["name"] in values}
    out["metrics"] = metrics
    out["device"] = device_record(cell.device, peak, summary if traced else None)
    if traced and summary:
        out["breakdown"] = trace_mod.breakdown(summary)
    del units
    t0 = time.time()
    checks = job.check()
    print(f"reference check {time.time() - t0:.1f} s", file=sys.stderr)
    del job
    gc.collect()
    out["correct"], out["checks"] = judge(checks, cell.limits)
    return out


def judge(values: dict, limits: dict) -> tuple[bool, dict]:
    """Each number beside its limit; correct when every number is finite and
    at most its limit (a number without a limit is never correct)."""
    checks = {k: {"value": v, "limit": limits.get(k)} for k, v in values.items()}
    ok = bool(values) and all(
        c["limit"] is not None and math.isfinite(c["value"]) and c["value"] <= c["limit"]
        for c in checks.values())
    return ok, checks


def device_record(device: torch.device, peak: int, summary: dict | None) -> dict:
    rec = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
           "count": 1, "memory_peak_bytes": int(peak)}
    if summary is not None:
        rec["busy_s"] = summary.get("busy_s", 0.0)
        rec["window_s"] = summary.get("window_s", 0.0)
    return rec
