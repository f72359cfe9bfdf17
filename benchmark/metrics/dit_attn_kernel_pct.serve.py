"""The share of the Wan2.1 DiT's attention calls that launched K1: 100 *
``dit.attn_kernel_n`` / ``dit.attn_n`` over the window's clips (every self-
and cross-attention call counted once, those that launched the kernel
again); nothing where the program counts no DiT attention call."""

UNIT, MOVES, SOURCE = "%", "frames_per_s", "program_counter"


def read(ctx):
    calls = sum(u.get("dit.attn_n", 0) for u in ctx.units)
    if not calls:
        return None
    return 100.0 * sum(u.get("dit.attn_kernel_n", 0) for u in ctx.units) / calls
