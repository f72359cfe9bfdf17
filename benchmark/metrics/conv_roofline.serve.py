"""The VAE convolutions' share of their roofline in a serving cell: the least
time of every convolution of the encoder and decoder, 3x3(x3) and 1x1x1, at
the whole padded frame (window overlap counts as waste; each conv the larger
of its operations at the dtype's peak and its bytes at the HBM rate) over the
device time of the convolution kernels (cuDNN's, K4, K5). Silent in modes
that quantize the VAE."""

from benchmark import counts, peaks
from benchmark.trace import kernel_seconds

UNIT, MOVES, SOURCE = "%", "frames_per_s", "device_trace"
PATTERNS = ("fprop", "conv", "implicit_gemm")
EXCLUDE = ("nchwtonhwc", "nhwctonchw")


def least_seconds(config, mix) -> float:
    dt, e = config["dtype"], counts.ELEM[config["dtype"]]
    sh = counts.staged_shapes(config, mix["frames"], mix["height"], mix["width"])
    vae = config["vae"]
    convs = (counts.vae_convs(vae, sh["frames"], sh["height"], sh["width"], "encoder", e)
             + counts.vae_convs(vae, sh["lat_frames"], sh["lat_h"], sh["lat_w"], "decoder", e))
    return sum(peaks.least_seconds(w.ops, w.nbytes, dt) for w in convs)


def read(ctx):
    if ctx.cell.mix.get("quantize") in counts.VAE_INT8:
        return None
    device = kernel_seconds(ctx.trace, PATTERNS, EXCLUDE)
    if not device:
        return None
    return 100.0 * len(ctx.units) * least_seconds(ctx.cell.config, ctx.cell.mix) / device
