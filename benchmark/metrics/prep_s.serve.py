"""A clip's host work before and after its stages, seconds a clip: the mean
over the window's clips of ``DovePipeline.stage_times["prep"] + ["finish"]``
(host spans of ``process_frames``: the padding and the [-1, 1] input, then
the chunks' collection and the trim)."""

UNIT, MOVES, SOURCE = "s", "frames_per_s", "program_span"


def read(ctx):
    vals = [u["prep"] + u["finish"] for u in ctx.units if "prep" in u and "finish" in u]
    return sum(vals) / len(vals) if vals else None
