"""Attention at head dim 128, its share of the roofline in a Wan2.1 cell: the
least time of the window's self- and cross-attention (Q K^T and P V of every
layer, ``counts_wan.py``, each the larger of its operations at the bf16 peak
and its bytes at the HBM rate) over the device time of K1 at head dim 128
(``flash_fwd_sm90_kernel_d128``). Nothing where that kernel did not run."""

from benchmark import counts_wan, peaks
from benchmark.trace import kernel_seconds

UNIT, MOVES, SOURCE = "%", "frames_per_s", "device_trace"
PATTERNS = ("flash_fwd_sm90_kernel_d128",)


def least_seconds(config, mix) -> float:
    work = counts_wan.dit_work(config, mix)
    return sum(peaks.least_seconds(work[p].ops, work[p].nbytes, config["dtype"])
               for p in ("self_attn", "cross_attn"))


def read(ctx):
    if not counts_wan.is_wan(ctx.cell.config):
        return None
    device = kernel_seconds(ctx.trace, PATTERNS)
    if not device:
        return None
    return 100.0 * len(ctx.units) * least_seconds(ctx.cell.config, ctx.cell.mix) / device
