"""The training step's backward, seconds a step: the mean over the window's
steps of ``Trainer.step_times["backward"]`` (``loss.backward()``, with the
checkpointed forward's recomputation, timed on the device's clock)."""

UNIT, MOVES, SOURCE = "s", "train_samples_per_s", "program_span"


def read(ctx):
    vals = [u["backward"] for u in ctx.units if "backward" in u]
    return sum(vals) / len(vals) if vals else None
