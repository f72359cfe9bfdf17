"""The share of the VAE windows' latent positions that overlap, computed
twice: 100 (1 - (enc.frame_px + dec.frame_px) / (enc.window_px +
dec.window_px)) over the window's clips, from the counters
``DovePipeline.stage_times`` carries (each window plan counted once a
clip)."""

UNIT, MOVES, SOURCE = "%", "frames_per_s", "program_counter"
KEYS = ("enc.frame_px", "dec.frame_px", "enc.window_px", "dec.window_px")


def read(ctx):
    units = [u for u in ctx.units if all(k in u for k in KEYS)]
    window = sum(u["enc.window_px"] + u["dec.window_px"] for u in units)
    if not window:
        return None
    frame = sum(u["enc.frame_px"] + u["dec.frame_px"] for u in units)
    return 100.0 * (1.0 - frame / window)
