"""The int8 DiT's quantizer passes, seconds a clip: the mean over the
window's clips of ``DovePipeline.stage_times["dit.quantize"] +
["dit.dequantize"]`` (the activations' int8 quantizers of the W8A8 linears
and of K2, and the linears' fp32 epilogue); nothing where the DiT runs in
its float dtype."""

UNIT, MOVES, SOURCE = "s", "frames_per_s", "program_span"
KEYS = ("dit.quantize", "dit.dequantize")


def read(ctx):
    vals = [sum(u.get(k, 0.0) for k in KEYS) for u in ctx.units
            if any(k in u for k in KEYS)]
    return sum(vals) / len(vals) if vals else None
