"""The whole clip's share of the card's peak: the least time of a clip's
model operations (the VAE's convolutions at the whole padded frame, the DiT's
linears and attention; each at the peak of the precision the mode computes
it in) times the clips of the window, over the window's seconds."""

from benchmark import counts, peaks

UNIT, MOVES, SOURCE = "%", "frames_per_s", "host_clock"


def read(ctx):
    if not ctx.units or not ctx.seconds:
        return None
    work = counts.clip_work(ctx.cell.config, ctx.cell.mix)
    least = sum(w.ops / peaks.FLOPS[dt] for w, dt in work.values())
    return 100.0 * len(ctx.units) * least / ctx.seconds
