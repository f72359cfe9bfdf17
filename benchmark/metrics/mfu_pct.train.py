"""The whole step's share of the card's peak: a step's model operations (the
encode of the LQ and HQ clips, the DiT forward and backward with the LoRA
products, attention forward and backward; no recomputation) at the dtype's
peak, times the window's steps, over the window's seconds."""

from benchmark import counts, peaks

UNIT, MOVES, SOURCE = "%", "train_samples_per_s", "host_clock"


def read(ctx):
    if not ctx.units or not ctx.seconds:
        return None
    work = counts.train_step_work(ctx.cell.config, ctx.cell.mix)
    least = sum(w.ops / peaks.FLOPS[dt] for w, dt in work.values())
    return 100.0 * len(ctx.units) * least / ctx.seconds
