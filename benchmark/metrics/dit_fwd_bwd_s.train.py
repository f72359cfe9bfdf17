"""The training step's ``dit_fwd_bwd`` lap, seconds a step: the mean over the
window's steps of ``Trainer.step_times["dit_fwd_bwd"]`` (laps the trainer ends with
a device synchronisation)."""

UNIT, MOVES, SOURCE = "s", "train_samples_per_s", "program_span"


def read(ctx):
    vals = [u["dit_fwd_bwd"] for u in ctx.units if "dit_fwd_bwd" in u]
    return sum(vals) / len(vals) if vals else None
