"""Attention's share of its roofline in a training cell: the least time of a
step's attention, forward (Q K^T, P V) and backward (dV, dP, dQ, dK) with no
recomputation, counted from the configuration and the batch's shapes, times
the window's steps, over the device time of K1-lse, K3a and K3b."""

from benchmark import counts, peaks
from benchmark.trace import kernel_seconds

UNIT, MOVES, SOURCE = "%", "train_samples_per_s", "device_trace"
PATTERNS = ("flash_fwd_sm90_kernel", "flash_bwd_dq_sm90_kernel", "flash_bwd_dkv_sm90_kernel")


def read(ctx):
    device = kernel_seconds(ctx.trace, PATTERNS)
    if not device:
        return None
    w, dt = counts.train_step_work(ctx.cell.config, ctx.cell.mix)["attention"]
    return 100.0 * len(ctx.units) * peaks.least_seconds(w.ops, w.nbytes, dt) / device
