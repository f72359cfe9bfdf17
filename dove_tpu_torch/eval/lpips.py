"""LPIPS perceptual metric (PyTorch). Needs pretrained VGG features and the
linear heads; see dove_tpu_torch/eval/vgg.py for the backbone.

Weights are read from a local file (no network access). Export them once
from the pyiqa/lpips package on any machine:

    import lpips, torch
    net = lpips.LPIPS(net='vgg')
    torch.save(net.state_dict(), 'lpips_vgg.pt')   # or safetensors

and point DOVE_LPIPS_WEIGHTS at the file.
"""

from __future__ import annotations

import os


def lpips_metric(device=None):
    path = os.environ.get("DOVE_LPIPS_WEIGHTS")
    if not path or not os.path.exists(path):
        raise NotImplementedError(
            "LPIPS needs pretrained VGG features: set DOVE_LPIPS_WEIGHTS to a "
            "locally exported lpips state dict (no downloads available here)"
        )
    from dove_tpu_torch.eval.vgg import load_lpips

    return load_lpips(path, device)
