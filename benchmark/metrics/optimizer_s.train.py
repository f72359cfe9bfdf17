"""The training step's optimizer, seconds a step: the mean over the window's
steps of ``Trainer.step_times["optimizer"]`` (the gradients' global norm,
the clip and the AdamW update)."""

UNIT, MOVES, SOURCE = "s", "train_samples_per_s", "program_span"


def read(ctx):
    vals = [u["optimizer"] for u in ctx.units if "optimizer" in u]
    return sum(vals) / len(vals) if vals else None
