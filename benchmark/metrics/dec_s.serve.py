"""The staged path's ``dec`` stage, seconds a clip: the mean over the window's
clips of ``DovePipeline.stage_times["dec"]`` (a span the program ends with a
device synchronisation)."""

UNIT, MOVES, SOURCE = "s", "frames_per_s", "program_span"


def read(ctx):
    vals = [u["dec"] for u in ctx.units if "dec" in u]
    return sum(vals) / len(vals) if vals else None
