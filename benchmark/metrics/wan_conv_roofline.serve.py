"""The Wan2.1 VAE's convolutions, their share of the roofline in a Wan2.1
cell: the least time of every convolution of the encode and the decode at
the frames the release's chunk rule computes (``counts_wan.vae_work``: the
3x3x3 causal convs, the 1x1x1 ones, the resamplers' per-frame 3x3 and
temporal 3x1x1 convs; each the larger of its operations at the bf16 peak and
its bytes at the HBM rate) over the device time of the convolution kernels
(cuDNN's; its layout kernels and any attention kernel left out). Nothing in
a cell whose configuration is not Wan2.1."""

from benchmark import counts_wan, peaks
from benchmark.trace import kernel_seconds

UNIT, MOVES, SOURCE = "%", "frames_per_s", "device_trace"
PATTERNS = ("fprop", "conv", "implicit_gemm", "cudnn")  # the breakdown's conv kind
EXCLUDE = ("nchwtonhwc", "nhwctonchw", "sdpa", "fmha", "flash")


def least_seconds(config, mix) -> float:
    return sum(peaks.least_seconds(w.ops, w.nbytes, config["dtype"])
               for w in counts_wan.vae_work(config, mix, attn=False))


def read(ctx):
    if not counts_wan.is_wan(ctx.cell.config):
        return None
    device = kernel_seconds(ctx.trace, PATTERNS, EXCLUDE)
    if not device:
        return None
    return 100.0 * len(ctx.units) * least_seconds(ctx.cell.config, ctx.cell.mix) / device
