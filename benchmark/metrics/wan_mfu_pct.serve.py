"""A Wan2.1 clip's share of the card's peak: the least time of the clip's
model operations (``counts_wan.py``: the DiT's linears, self- and
cross-attention, every VAE convolution and the VAE's middle attention, all
at the bf16 peak) times the clips of the window, over the window's seconds.
Nothing in a cell whose configuration is not Wan2.1."""

from benchmark import counts_wan, peaks

UNIT, MOVES, SOURCE = "%", "frames_per_s", "host_clock"


def read(ctx):
    if not counts_wan.is_wan(ctx.cell.config) or not ctx.units or not ctx.seconds:
        return None
    work = counts_wan.clip_work(ctx.cell.config, ctx.cell.mix)
    least = sum(w.ops for w in work.values()) / peaks.FLOPS[ctx.cell.config["dtype"]]
    return 100.0 * len(ctx.units) * least / ctx.seconds
