"""The training step's ``encode`` lap, seconds a step: the mean over the
window's steps of ``Trainer.step_times["encode"]`` (laps the trainer ends with
a device synchronisation)."""

UNIT, MOVES, SOURCE = "s", "train_samples_per_s", "program_span"


def read(ctx):
    vals = [u["encode"] for u in ctx.units if "encode" in u]
    return sum(vals) / len(vals) if vals else None
