"""The share of the VAE's norm sites that ran the fused GroupNorm kernel:
100 * vae.norm_fused_n / vae.norm_n over the window's clips, from the
counters ``DovePipeline.stage_times`` carries (every norm site of every
encode and decode window counted once, the fused ones again); nothing
where the program counts no norm site."""

UNIT, MOVES, SOURCE = "%", "frames_per_s", "program_counter"


def read(ctx):
    sites = sum(u.get("vae.norm_n", 0) for u in ctx.units)
    if not sites:
        return None
    return 100.0 * sum(u.get("vae.norm_fused_n", 0) for u in ctx.units) / sites
