"""The training data pipeline: counterpart of ``dove_tpu/data``.

``datasets`` (the stage-1 and stage-2 datasets, the bucket sampler, the
prompt and latent caches), ``degradation`` (the two-stage synthesizer, torch
pixel work on the JAX package's NumPy draws), ``blur_kernels``,
``yaml_lite`` (the degradation configs without PyYAML) and ``loader`` (a
DataLoader with the JAX loader's batches). Importing it loads none of
OpenCV, PyYAML, safetensors, PyAV or JAX.
"""

from dove_tpu_torch.data.datasets import (
    BucketSampler,
    RealSRDataset,
    RealSRImageVideoDataset,
)
from dove_tpu_torch.data.loader import Loader, collate

__all__ = [
    "BucketSampler",
    "RealSRDataset",
    "RealSRImageVideoDataset",
    "Loader",
    "collate",
]
