"""The Wan2.1 DiT's cross-attention, seconds a clip: the mean over the
window's clips of ``DovePipeline.stage_times["dit.cross_attn"]`` (each
block's norm3, q, k and v projections, attention to the 512 text slots and
output projection, summed over the 40 blocks); nothing where no clip
recorded the span."""

UNIT, MOVES, SOURCE = "s", "frames_per_s", "program_span"
KEY = "dit.cross_attn"


def read(ctx):
    vals = [u[KEY] for u in ctx.units if KEY in u]
    return sum(vals) / len(vals) if vals else None
