"""The staged path's ``enc`` stage, seconds a clip: the mean over the window's
clips of ``DovePipeline.stage_times["enc"]`` (a span the program ends with a
device synchronisation)."""

UNIT, MOVES, SOURCE = "s", "frames_per_s", "program_span"


def read(ctx):
    vals = [u["enc"] for u in ctx.units if "enc" in u]
    return sum(vals) / len(vals) if vals else None
