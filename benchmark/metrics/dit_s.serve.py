"""The staged path's ``dit`` stage, seconds a clip: the mean over the window's
clips of ``DovePipeline.stage_times["dit"]`` (a span the program ends with a
device synchronisation)."""

UNIT, MOVES, SOURCE = "s", "frames_per_s", "program_span"


def read(ctx):
    vals = [u["dit"] for u in ctx.units if "dit" in u]
    return sum(vals) / len(vals) if vals else None
