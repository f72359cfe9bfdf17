"""Seconds a clip outside the three stages: the clip's wall time less
``enc + dit + dec`` of ``DovePipeline.stage_times`` (padding, the trim and
the host copies around ``process_frames``), mean over the window's clips."""

UNIT, MOVES, SOURCE = "s", "frames_per_s", "program_span"
STAGES = ("enc", "dit", "dec")


def read(ctx):
    vals = [u["wall"] - sum(u[s] for s in STAGES) for u in ctx.units
            if all(s in u for s in STAGES)]
    return sum(vals) / len(vals) if vals else None
