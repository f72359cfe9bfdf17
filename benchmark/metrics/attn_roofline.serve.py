"""Attention's share of its roofline in a serving cell: the least time of the
window's joint attention (Q K^T and P V of every layer, counted from the
configuration and the clip's shapes; Q K^T at the int8 peak where the mode
quantizes it) over the device time of the attention kernels (K1, K2)."""

from benchmark import counts, peaks
from benchmark.trace import kernel_seconds

UNIT, MOVES, SOURCE = "%", "frames_per_s", "device_trace"
PATTERNS = ("flash_fwd_sm90_kernel",)


def least_seconds(config, mix) -> float:
    work = counts.clip_work(config, mix)
    return sum(peaks.least_seconds(w.ops, w.nbytes, dt)
               for part, (w, dt) in work.items() if part in ("attn_qk", "attn_pv"))


def read(ctx):
    device = kernel_seconds(ctx.trace, PATTERNS)
    if not device:
        return None
    return 100.0 * len(ctx.units) * least_seconds(ctx.cell.config, ctx.cell.mix) / device
