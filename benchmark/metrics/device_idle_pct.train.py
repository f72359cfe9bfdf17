"""The share of the traced window in which no kernel, copy or set ran on the
device: 100 (1 - merged device intervals / window)."""

UNIT, MOVES, SOURCE = "%", "train_samples_per_s", "device_trace"


def read(ctx):
    if not ctx.trace.get("window_s"):
        return None
    return 100.0 * (1.0 - ctx.trace["busy_s"] / ctx.trace["window_s"])
