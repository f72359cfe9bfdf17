"""dove_tpu_torch: DOVE one-step video super-resolution in PyTorch and CUDA.

The port of ``dove_tpu`` (JAX on a TPU) to PyTorch on an NVIDIA H100. It
imports neither JAX nor ``dove_tpu``. The slice ported so far is the staged
bf16/fp32 inference path of CogVideoX1.5-5B; its one TPU kernel, the
flash-attention forward, is a hand-written CUDA kernel
(``csrc/flash_fwd.cu``, bound in ``ops/flash_attention.py``). Entry points run
on the card unless the caller passes ``device="cpu"``.
"""

from dove_tpu_torch.config import (
    DiTConfig,
    PipelineConfig,
    SchedulerConfig,
    VAEConfig,
    cogvideox1_5_5b,
    cogvideox_2b,
    pipeline_config_from_pretrained,
    tiny_test,
)
from dove_tpu_torch.models.dit import CogVideoXTransformer3D, init_dit_params
from dove_tpu_torch.models.vae import AutoencoderKLCogVideoX, init_vae_params
from dove_tpu_torch.pipeline import DovePipeline

__all__ = [
    "AutoencoderKLCogVideoX",
    "CogVideoXTransformer3D",
    "DiTConfig",
    "DovePipeline",
    "PipelineConfig",
    "SchedulerConfig",
    "VAEConfig",
    "cogvideox1_5_5b",
    "cogvideox_2b",
    "init_dit_params",
    "init_vae_params",
    "pipeline_config_from_pretrained",
    "tiny_test",
]
