"""The share of the VAE's float convolutions on the card whose input was
channels-last: 100 * vae.conv_cl_n / vae.conv_n over the window's clips, from
the counters ``DovePipeline.stage_times`` carries (every float conv of every
encode and decode window counted once, the channels-last ones again);
nothing where the program counts no conv."""

UNIT, MOVES, SOURCE = "%", "frames_per_s", "program_counter"


def read(ctx):
    convs = sum(u.get("vae.conv_n", 0) for u in ctx.units)
    if not convs:
        return None
    return 100.0 * sum(u.get("vae.conv_cl_n", 0) for u in ctx.units) / convs
