"""dove_tpu_torch: DOVE one-step video super-resolution in PyTorch and CUDA.

The port of ``dove_tpu`` (JAX on a TPU) to PyTorch on an NVIDIA H100. It
imports neither JAX nor ``dove_tpu``. What is ported so far is inference
with CogVideoX1.5-5B, staged (``vae_tiling=True``) or on the fused
outer-tile path (the default), through ``python -m dove_tpu_torch.inference``
with the JAX CLI's flags, in bf16 or fp32, unquantized or in the
five int8 serving modes (``quantize="int8"``, ``"int8-dit"``, ``"int8-vae"``,
``"int8w"``, ``"int8-dit-dec"``; ``ops/quant.py``), with long clips streamed
or cut into chunks; and both training stages, LoRA or SFT
(``train/trainer.py``: ``DOVES1Trainer``, and ``DOVES2Trainer`` with the VAE
decode under autograd and the VGG16 perceptual losses of ``eval/``); and the
full-reference metrics (``eval/metrics.py``, ``python -m
dove_tpu_torch.eval_metrics``). Its TPU kernels are hand-written
CUDA kernels: the flash-attention forward in bf16 (K1, with the logsumexp in
its training form) and with int8 Q K^T (K2, the same kernel template with s8
wgmma and int8 TMA maps) in ``csrc/flash_fwd_sm90.cu``, the flash-attention
backward (K3a, K3b; like K1 on wgmma and TMA) in ``csrc/flash_bwd_sm90.cu``
(bound in ``ops/flash_attention.py``), and the 3x3x3 tap convolution in int8
(K4) and bf16 (K5) in ``csrc/conv3d_taps_sm90.cu`` (bound in
``ops/conv3d_int8.py``).
Several devices run one process each on ``torch.distributed``
(``parallel/``: NCCL on the card, gloo on the CPU): the tensor- and
sequence-parallel DiT, data-parallel serving, DDP, FSDP and tensor-parallel
training, launched by ``torchrun``.
Entry points run on the card unless the caller passes ``device="cpu"``.
Checkpoints are read and written by the port's own ``safetensors_io``.
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
