"""DISTS perceptual metric (PyTorch). Needs pretrained VGG16 features and
the DISTS alpha/beta weights; see dove_tpu_torch/eval/vgg.py.

Export them once from pyiqa on a machine with downloads, then set
DOVE_DISTS_WEIGHTS to the saved state dict.
"""

from __future__ import annotations

import os


def dists_metric(device=None):
    path = os.environ.get("DOVE_DISTS_WEIGHTS")
    if not path or not os.path.exists(path):
        raise NotImplementedError(
            "DISTS needs pretrained VGG16 features: set DOVE_DISTS_WEIGHTS to "
            "a locally exported DISTS state dict (no downloads available here)"
        )
    from dove_tpu_torch.eval.vgg import load_dists

    return load_dists(path, device)
