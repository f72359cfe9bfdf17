#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (dove_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one result line each; any failure exits non-zero:

1. device and build: the card's name and power limit, and the nvcc builds of
   every kernel source under dove_tpu_torch/csrc/, one nvcc each, started
   together (flash_fwd_sm90 holds K1 and K2, flash_bwd_sm90 K3a and K3b,
   conv3d_taps_sm90 K4 and K5, conv3d_taps the int8 quantizer's pass,
   group_norm_sm90 the VAE's fused GroupNorm),
   with ptxas's registers, shared memory and spills for each kernel form,
   and each form's count of HGMMA / IGMMA (wgmma on bf16 / int8), UTMALDG
   (TMA load), UBLKCP (bulk copy) and HMMA / IMMA (mma.sync) in its SASS
   where the toolkit has cuobjdump: every K1, K2, K3a, K3b, K4 and K5 form,
   bf16 and fp16, must issue wgmma and TMA loads and no mma.sync, and
   spill nothing (K2 both int8 and bf16 or fp16 wgmma); which media packages (PIL, cv2,
   torchvision.io, av, imageio) and tool packages (transformers, regex, ftfy, scipy.io) the
   card's Python imports, whether an ffmpeg binary is on the PATH, and
   whether the port's io/video.py writes an mp4 and reads it back;
2. K1 (the bf16 flash-attention forward, wgmma/TMA) against its plain
   PyTorch version on the card, bounded and online-softmax forms, at the
   main path's shape, 4097 and 200, and at every Sq, Skv around its
   128- and 192-row tiles with B*H = 3, and beside heads of NaN; each of its four
   forms timed beside SDPA, the bound and the exp floor;
3. the staged pipeline at full widths and 2 DiT layers, run once through the
   kernel and once through the plain attention, compared by PSNR;
4. the bf16 main path: CogVideoX1.5-5B at full width, all 42 layers, seeded
   random weights, through DovePipeline.process_frames on a 32-frame
   180x320 clip (720p out), with the kernels' launches counted;
5. K2 (the int8 Q K^T flash-attention forward) against its plain version on
   the same int8 codes, at the main path's shape, 4097 and a ragged 200, at
   K1's bars, and at every Sq, Skv of phase 2 and beside heads whose K codes
   are all 127 and V NaN; its drift from K1 on the same bf16 inputs; K2 and
   K1 timed in interleaved windows, the quantizer on its own, plain and SDPA
   times beside the bound and the exp floor;
6. the int8-dit pipeline at full widths and 2 DiT layers, through K2 and
   through K2's plain version, compared by PSNR;
7. the int8-dit main path: the 5B DiT quantized on the card (W8A8 linears,
   K2 attention), the 32-frame clip of phase 4;
8. the streamed path: the same int8-dit pipeline on a 100-frame 180x320 clip
   (105 frames padded, 27 latents, four 10-latent DiT windows);
9. the training attention: K1's logsumexp form, K3a and K3b (the backward)
   against their plain versions at the stage-1 training shape
   [2, 48, 3426, 64], at stage 2's [1, 48, 1026, 64] (timed too) and at a
   ragged Sq != Skv, at K1's bars (and an
   absolute bar on the logsumexp), with the bars shown to reject a dropped
   tile; K1's training forms, K3a and K3b also at every Sq, Skv of phase 2
   and beside NaN heads; kernel, plain and SDPA times beside the bounds,
   K1's four forms with the exp floor;
10. one stage-1 LoRA training step at full width and 2 DiT layers, once
   through the kernels and once through the plain attention, from the same
   LoRA (B nonzero) and batch: loss and LoRA gradients compared;
11. the stage-1 recipe (scripts/train_s1.sh): CogVideoX1.5-5B at full width,
   all 42 layers, seeded bf16 weights, LoRA rank 128 / alpha 64, a synthetic
   batch of 2 clips of 25x320x640, three steps through DOVES1Trainer with
   the kernels' launches counted per step, then a checkpoint saved and
   resumed on the card, and the LoRA exported, read back through the port's
   own safetensors reader and fused into the DiT;
12. K4 (the W8A8 3x3x3 tap conv) and K5 (the same schedule in bf16) against
   their plain versions at the shapes the int8 decode of the 32-frame clip
   gives them (every channel width of the 5B decoder, the per-frame k_t = 1
   form, a ragged shape) and at a ragged sweep around the kernel's tiles
   (Ho and Wo in 1, 63-65, 127-129, 383-385; Fo = 1, two windows, Cin 64 to
   512, Cout 128 and 256, k_t 1 and 3): K4 equal bit for bit in its three
   output forms, K5 within 2e-5 of the largest output in fp32 and one bf16
   ulp in bf16, with a plain version that skips one tap shown to be
   rejected; K5 beside a window and a frame of NaN equal to its plain
   version wherever the NaN is not an input; kernel, plain and cuDNN times
   beside the bound;
13. the quantize="int8" pipeline (int8 DiT, encoder and decoder) at full
   widths and 2 DiT layers: through K4 and through K4's plain version (uint8
   outputs identical), and through K2 and its plain version (PSNR), with K4's
   launches held to the count the window plan predicts;
14. the int8-dit-dec main path: the 5B model at all 42 layers, the decoder
   int8 outside the "lowres" exclusion set and equalized from synthetic
   calibration stats, the 32-frame clip of phase 4;
15. K5 opt-in: the bf16 pipeline of phase 3 with hand_conv on and off;
16. one stage-2 SFT step (DOVES2Trainer: per-frame encode, one DiT pass,
   the decode with gradients, DISTS on a seeded VGG16, frame differences) at
   full width and 2 DiT layers on a 2x320x640 clip pair and on an image
   pair, each through the kernels and through the plain attention: loss
   terms and every DiT gradient compared; the decode with and without
   checkpointing per level compared;
17. the stage-2 recipe (scripts/train_s2.sh): CogVideoX1.5-5B at full
   width, all 42 layers, SFT of the whole DiT with AdamW, three steps
   through DOVES2Trainer.train_step from a seed whose coin gives both an
   image step and a video step, with the split, launches and loss terms per
   step and the peak memory;
18. the fused outer-tile path (no --is_vae_st) at full widths and 2 DiT
   layers: first on a 9x64x128 clip under each --upscale_mode but bilinear
   (bicubic, nearest, area, lanczos: ops/resize.py on the card, held to the
   same op on the CPU), K1's launches held to the measured calls; then on
   a 17-frame 180x320 clip in 256x256 tiles of 16-frame chunks,
   two tiles a call, every DiT pass under 2048 tokens: through K1 and
   through the plain attention, then under int8-dit through K2 and
   "plain-qk8", compared by PSNR, with the launches held to layers x the
   calls and tokens measured in the run; then under quantize="int8" on a
   9x64x128 clip, K4 on the tiles' convs against its plain version and K2
   against "plain-qk8"; and the staged path at --upscale 1 on a 720x1280
   input, its pipeline built by the CLI's load_pipeline;
19. the fused path at full width and depth (42 layers), built by the CLI's
   load_pipeline from its docstring's flags (384x384 tiles, 16-frame
   chunks), on the clip of phase 4, through K1 and through the plain
   attention on the same weights, compared by PSNR, with K1's launches and
   the peak memory; then the same clip untiled (one spatial tile, 16-frame
   chunks) and through the staged path; then K1 and K2 against their plain
   versions at every q shape the fused and untiled runs launched K1 at;
20. scoring on the card: psnr, ssim, lpips and dists (on seeded VGG16 state
   dicts the phase writes) of phase 19's fused clip against its staged
   clip, in-process, and through ``python -m dove_tpu_torch.eval_metrics``
   on the two clips written as PNG folders: the same averages;
21. the no-reference scores on the card: clipiqa (a CLIP ViT-B/32 snapshot),
   niqe, musiq, maniqa and ewarp (RAFT) on seeded checkpoints at the
   published widths, written in the published layouts, of phase 19's fused
   clip read back from phase 20's PNGs: through ``python -m
   dove_tpu_torch.eval_metrics`` with no --gt_dir and in-process through a
   MetricAccumulator, the same scores; clipiqa also on an OpenAI RN50 .pt,
   both ways; seconds and peak memory per metric; one RAFT pass over
   ewarp's chunk of pairs timed through cuDNN and through PyTorch's own
   convolutions (the port's route);
22. the training data pipeline at the stage-1 recipe's size: RealSRDataset
   (a subclass whose read_clip makes seeded smooth 40x540x960 clips: the
   card decoded no video file before) cropping 35x480x960 for 25x320x640,
   with configs/degradation.yaml (where OpenCV does not import, less mpeg4:
   its share moved to libx264 and h264, as mpeg4 needs OpenCV's writer);
   one item's seconds by op, items/s in this process and through the
   DataLoader at 8 worker processes (and at the host's core count), the
   workers' first batch equal to the in-process one, the peak host RSS, a
   stage-2 item with its image pair from a PNG file, Pillow's libjpeg;
23. the training entry point at 2 layers (42 until the run outgrew its
   time limit): ``python -m
   dove_tpu_torch.train``'s main with scripts/train_s1.sh's flags (4 steps,
   a checkpoint every 2, validation every 2 on two PNG-folder clips with
   GT, psnr and ssim, items made in this process) on phase 22's dataset:
   step walls,
   the loader's wait, K1-lse / K3a / K3b launches per step and K1 launches
   per validation (layers x DiT passes), validation seconds and peak; a
   resume from checkpoint-2 repeating steps 3 and 4; 2 steps of the
   is_latent route (the cache filled in this process); 2 steps of
   scripts/train_s2.sh's flags; and phase 22's first two batches through 2
   layers with the kernels and with the plain attention.
24. video files (ROADMAP C.2): two seeded LQ clips written as mp4 through
   io/video.save_video (33x180x320 and 9x96x160), ``python -m
   dove_tpu_torch.inference``'s main over them with --is_vae_st at 2 layers,
   once to mp4 and once with --png_save; each output decoded by
   read_video_frames to 4x the size and the same frame count, held to
   load_pipeline + process_frames on the decoded input (mp4: Y-subsampled
   I420 and mp4v's loss, >= 30 dB; PNG: lossless, the 40 dB bar), K1's
   launches = layers x clips; then a RealSRDataset over mp4 clips with
   configs/degradation.yaml, two items, the sampled mpeg4 round-tripping
   through OpenCV (fails loudly without cv2);
25. the int8 drift report (ROADMAP A.4): dove_tpu_torch.int8_drift_report's
   runs at 42 layers on its 33x180x320 fixture for both synthetic weight
   families: bf16 with its calibration, the decoder's weight floor
   (int8_weight_floor) and the per-conv attribution, then int8w, int8-dit, int8-dit with bf16 attention,
   int8-dit-dec --exclude lowres and int8 with that calibration; per run
   the per-stage rel_err, the Y-PSNR against bf16 beside the JAX frontier's
   number (int8w and int8-dit must reach its 45 dB bar), seconds, peak
   memory and K1 / K2 / K4 / quantizer launches against the window plan;
26. the optimizers (ROADMAP A.8): one scripts/train_s2.sh SFT step at 42
   layers with each of adamw, adamw-8bit, adamw-4bit, came and prodigy
   (step seconds, the optimizer split, peak memory, state bytes, a finite
   loss and weights, K1-lse / K3a / K3b per step); then ``python -m
   dove_tpu_torch.train``'s main at 2 layers with
   --gradient_accumulation_steps 2 --report_to all for 4 micro-steps and a
   resume from checkpoint-3 that repeats step 4 and the final state bit for
   bit, with the offline wandb run's files and the tfevents;
27. the fp16 kernel forms (ROADMAP A.14) against their plain versions: K1's
   four forms and K2 with fp16 V and O at the 2B's [1, 30, 34786, 64] and
   the 5B's [1, 48, 19426, 64], K1-lse, K3a and K3b at both stage-1 shapes
   ([2, 30, 5826, 64], [2, 48, 3426, 64]), each timed beside SDPA in fp16
   with its bound, the ragged Sq, Skv sweep and NaN heads of phases 2, 5
   and 9 in fp16, K4's fp16 epilogue equal and K5's fp16 out within its bar
   at phase 12's main shape, the quantizer's pass on fp16 equal; and K1 in
   bf16 at the 2B's serving shape;
28. the CogVideoX-2B family (ROADMAP A.10) at 30 layers on the main path's
   clip in bf16, fp16 and fp16 int8-dit, with each layer's largest logit;
   2-layer 2B pipelines through the kernels and the plain attention in
   bf16 and fp16, and in fp16 int8-dit-dec with hand_conv (K4, K5 and the
   quantizer in fp16); the 5B at 42 layers in fp16 against phase 4's clip;
   ``python -m dove_tpu_torch.inference --preset cogvideox-2b --dtype
   float16`` on mp4 clips at 2 layers;
29. fp16 training: a 2-layer stage-1 step through the kernels and through
   the plain attention for the 5B and the 2B (on a scaled loss: the JAX
   package trains fp16 without loss scaling, and at full width the q, k, v
   LoRA gradients underflow to 0, which the phase records), then three
   stage-1 steps with --base_preset cogvideox-2b at 30 layers in bf16 and
   in fp16;
30. parallel/ on torch.distributed (ROADMAP A.12) with one card: (a) two
   ranks over gloo and one over NCCL, each a subprocess of this script on
   the card, probe which collectives take CUDA tensors in bf16 and fp32;
   (b) under an NCCL group of one rank, phase 4's clip through
   process_frames(mesh=make_mesh(1, 1)) and phase 11's first stage-1 step
   at 42 layers, each equal to its run without a group, with K1 and K1-lse /
   K3a / K3b launches; (c) where gloo all-reduces CUDA tensors, two ranks
   sharing the card: the 5B DiT at full width and 4 layers split two ways
   (24 heads a rank, K1 and K2 launched once a layer) and token-sharded
   two ways (sequence parallelism) against the whole DiT in bf16 and
   int8-dit, and a tensor-parallel stage-1 step at 2 layers against one
   process. A correctness run: two ranks on one card measure no
   speed-up;
31. T5-XXL (24 blocks, d_model 4096, 4.76 B parameters) on seeded weights
   built on the card, one seeded 226-token sequence: bf16 time (the median
   and range of 20 calls timed one by one by CUDA events after 3 warm-ups,
   and the host's time to issue a call) and peak memory, held to the same
   module in fp32;
32. a non-empty prompt through ``python -m dove_tpu_torch.inference``: phase
   24's two mp4 clips at 2 layers from a model folder the phase writes (phase
   24's seeded DiT and VAE, a one-block T5 at XXL's width as text_encoder/,
   a word-level tokenizer/), a prompt on one clip: its frames differ from
   phase 24's empty-prompt PNG run, the other clip's are equal (fails loudly
   without tokenizers or transformers);
33. RAFT and flow fusion: raft_bi_clip on the main path's 32-frame 180x320
   LQ clip (resized to 184 and back, 25-frame windows), then
   optical_flow_feature, fusion_module_forward (the identity at init,
   exactly) and the learnable propagation_forward (mid_channels 256, 16
   groups) on a [1, 9, 90, 160, 16] tensor; times and peak memory;
34. whole-tensor optimizer statistics on split tensors (ROADMAP C.7): two
   gloo ranks on the card, phase 30(c)'s 2-layer step under SFT with CAME,
   Prodigy, 8- and 4-bit AdamW under tensor_parallel=2 and fsdp=2: loss
   and gradients against the one-process step, each sharded optimizer step
   against one device's optimizer on the gathered gradient (weights within
   one bf16 ulp, statistics and codes), K1-lse, K3a and K3b launches per
   rank;
35. the VAE's fused GroupNorm (ops/group_norm.py, group_norm_sm90.cu, the
   port's own kernels): at the decoder's finest window, [1, 128, 33,
   208, 200] bf16 with the spatial modulation of a [1, 16, 9, 26, 25]
   latent, and at the encoder's, [1, 128, 33, 208, 232], each form held to
   its float32 plain version: the NCDHW pair, and the channels-last form
   writing two left frames in front of its output; each kernel timed apart
   (torch.profiler) and each form together (CUDA events) beside its bytes
   bound, the plain version and the library route the port no longer takes
   (F.group_norm, the affine, the nearest resize of the modulation, SiLU);
   and a norm site with its causal conv both ways: the channels-last form
   and cuDNN reading its output in place, against the route it replaced
   (x.contiguous(), the NCDHW pair, torch.cat of the left frames, cuDNN on
   NCDHW with its layout transposes);
36. K1 at head dim 128 (``flash_fwd_sm90_kernel_d128``, bf16, online, no
   logsumexp: Wan2.1's attention) against its plain version at Wan2.1-14B's
   self-attention [1, 40, 34560, 128] and cross-attention (34560 queries, 512
   keys), with logits as large as Wan's RMS norms allow, at every Sq, Skv
   around its 128-row tiles with B*H = 3 and beside heads of NaN; both
   shapes timed beside the bound, the exp floor, the plain version and SDPA.

Then one JSON line with the kernels' numbers, the card's name and power
limit, and as the last line {"ok": true, "device": {...}}.

Exits non-zero with no result when no CUDA device is present. It imports
torch, numpy, the standard library and dove_tpu_torch, nothing else.
"""

from __future__ import annotations

import json
import math
import re
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

from dove_tpu_torch.data.datasets import RealSRDataset, RealSRImageVideoDataset

# H100 SXM data sheet (dense): 989 TFLOP/s bf16 and 1,979 TOP/s int8 on the
# tensor cores, 3.35 TB/s HBM.
PEAK_BF16_FLOPS = 989e12
PEAK_INT8_OPS = 1979e12
PEAK_BYTES = 3.35e12
# K1 against its plain version, bf16. The absolute bar is that of
# tests/test_flash_attention.py; at the main path's length a typical output is
# ~0.012 (a softmax average over ~S/e keys of unit-variance values), so the
# error is also held relative to the reference: its largest value, and its RMS.
# Dropping one 64-key tile of 18226 moves the output by ~6% RMS.
K1_ABS_TOL = 3e-2  # max |out - ref|
K1_REL_MAX_TOL = 2e-2  # max |out - ref| / max |ref|
K1_REL_RMS_TOL = 1e-2  # rms(out - ref) / rms(ref)
PSNR_BAR_DB = 40.0
# K2 against K1 on the same bf16 inputs: the drift of per-tensor int8 Q K^T
# itself, held to the bar of tests/test_flash_attention.py:94 (RMS relative).
K2_DRIFT_TOL = 2e-2
# K2 and K1 bounded are timed in this many interleaved 10-launch windows
# each (phase 5) and compared by their medians.
K2_WINDOWS = 5
# K1's logsumexp against its plain version: both fp32 from the same bf16
# inputs, apart in summation order and ex2.approx; 1e-3 keeps p = exp(s -
# lse) in the backward within 0.1%.
K1_LSE_ABS_TOL = 1e-3
# The training step through the kernels against the same step through the
# plain attention (phase 10): both bf16, rounded at the same points, apart
# by the kernels' bf16 outputs (one ulp here and there, ~2e-3 RMS) through
# two layers and the backward.
# K3a's dQ and K3b's dK with a single key in the online form are exactly 0
# (p = 1, o = v): the rounding residue either side may show, fp32 dot
# products of 64 bf16 products of unit-variance values apart in summation
# order, times |k|.
ZERO_GRAD_TOL = 1e-4
TRAIN_LOSS_REL_TOL = 1e-2
TRAIN_GRAD_REL_RMS_TOL = 5e-2

# Main-path clip: the bench.py clip, 32 LQ frames of 180x320 -> 720p.
CLIP_FRAMES, CLIP_H, CLIP_W = 32, 180, 320
# Stage-1 training (scripts/train_s1.sh): batch 2 of 25x320x640, whose DiT
# pass is 226 text + 4 x 20 x 40 video tokens.
TRAIN_BATCH, TRAIN_FRAMES, TRAIN_H, TRAIN_W = 2, 25, 320, 640
TRAIN_SEQ = 3426
TRAIN_STEPS = 3
# Stage-2 training (scripts/train_s2.sh): a clip pair of 2x320x640 and an
# image pair of 1x320x640, batch 1; every frame encodes as a clip of its own.
S2_FRAMES, S2_H, S2_W = 2, 320, 640
S2_STEPS = 3
# The decode with gradients, with and without checkpointing per level
# (phase 16): the same convs on the same inputs, recomputed; pixels and the
# gradient held to 1e-3 of their RMS (bit for bit is expected; the bar
# allows cuDNN a different algorithm on the recompute).
REMAT_REL_RMS_TOL = 1e-3
# The fused outer-tile path (phases 18-19): phase 18's 2-layer tiles of
# 256x256 in 16-frame chunks, two tiles a call, whose DiT passes are all under
# 2048 tokens; phase 19 the CLI docstring's 384x384 tiles and 16-frame chunks.
FUSED_2L = dict(tile_size_hw=(256, 256), chunk_len=16, tile_batch=2)
FUSED_2L_FRAMES = 17
FUSED_CLI = ["--tile_size_hw", "384", "384", "--chunk_len", "16"]
# Scoring (phase 20): the in-process metrics against the eval_metrics CLI's
# on the same frames read back from PNG; PSNR and SSIM are float64, LPIPS
# and DISTS fp32 through VGG16 in two processes.
SCORE_REL_TOL = {"psnr": 1e-6, "ssim": 1e-6, "lpips": 1e-5, "dists": 1e-5}
# ops/resize.py against cv2.resize on float32, tests/test_torch_resize.py's
# bars; phase 18 holds the device resize to the same op on the CPU by them
RESIZE_ATOL = {"linear": 1e-6, "nearest": 0.0, "area": 1e-6, "cubic": 3e-6,
               "lanczos4": 1e-6}
# The no-reference scores (phase 21): the CLI's against the in-process
# accumulator's on the same PNG frames, relative.
NR_METRICS = ("clipiqa", "niqe", "musiq", "maniqa", "ewarp")
NR_REL_TOL = 1e-6
# RAFT's iterations in phase 21's cuDNN comparison (ewarp's chunk of pairs)
RAFT_CUDNN_ITERS = 2
# OpenAI CLIP RN50: stem width, attention-pool heads, embedding width
RN50_WIDTH, RN50_HEADS, RN50_OUT = 64, 32, 1024
# The data pipeline and the training entry point (phases 22, 23): seeded
# source clips of 40x540x960 (crops of 35x480x960 for 25x320x640), 16
# manifest entries for the loader's rates, 4 for the recipe runs (two steps
# an epoch, so a resume at step 2 starts an epoch; phase 23 makes its items
# in its own process, where 8 threads make one in ~4 s, against ~40 s in
# a one-thread worker), DIV2K-sized PNG images,
# two 9x180x320 validation clips; the stage-1 step the loader must keep up
# with (PERF.md section 5, G1); a resumed step against the first run's at one
# bf16 ulp, relative.
DATA_DIR = "build/chip_smoke_data"
SOURCE_FRAMES, SOURCE_H, SOURCE_W = 40, 540, 960
DATA_CLIPS, RECIPE_CLIPS = 16, 4
IMAGE_HW = (1356, 2040)
VAL_CLIPS, VAL_FRAMES, VAL_H, VAL_W = 2, 9, 180, 320
LOADER_WORKERS = 8
STEP_S1_S = 2.100
RESUME_LOSS_REL_TOL = 2.0 ** -8
# Video files (phase 24, ROADMAP C.2): two LQ clips written as mp4v, the
# CLI's mp4 output held to the in-process frames within the codec's loss
# (Y, U, V subsampled on the device, then MPEG-4 Part 2 at OpenCV's default
# quality), and a dataset of mp4 clips cut to a short item.
VIDEO_DIR = "build/chip_smoke_video"
VIDEO_CLIPS = ((33, 180, 320), (9, 96, 160))
VIDEO_CODEC_PSNR_DB = 30.0
DATASET_CLIPS, DATASET_SOURCE, DATASET_RES = 2, (20, 144, 256), (5, 64, 128)
# The drift report (phase 25): dove_tpu_torch.int8_drift_report's fixture,
# the modes of docs/reports/QUANT_FRONTIER.md's rows (label, mode, attention,
# calibrated, exclusions), the frontier's Y-PSNR against bf16 (gaussian /
# outlier, its "HEAD" rows), and its 45 dB quality bar for the DiT modes.
DRIFT_FIXTURE = (33, 180, 320)
DRIFT_MODES = (
    ("int8w", "int8w", None, False, ()),
    ("int8-dit", "int8-dit", None, False, ()),
    ("int8-dit@flash", "int8-dit", "flash", False, ()),
    ("int8-dit-dec lowres", "int8-dit-dec", None, True, ("lowres",)),
    ("int8", "int8", None, True, ()),
)
FRONTIER_DB = {"int8w": {"gaussian": 49.2, "outlier": 49.7},
               "int8-dit": {"gaussian": 49.1, "outlier": 48.9},
               "int8-dit-dec lowres": {"gaussian": 46.3, "outlier": 38.8},
               "int8": {"gaussian": 36.0, "outlier": 31.1}}
DRIFT_BAR_MODES, DRIFT_BAR_DB = ("int8w", "int8-dit"), 45.0
# The optimizers (phase 26) and the accumulation run's item size (phase 22's
# clips, cut from train_s1.sh's 25 frames to keep its 4 micro-steps short).
OPT_NAMES = ("adamw", "adamw-8bit", "adamw-4bit", "came", "prodigy")
OPT_ACCUM_RES = (5, 320, 640)
# The streamed clip: 100 frames pad to 105, 27 latents, 4 DiT windows.
STREAM_FRAMES = 100
# K5 against its plain version: fp32 products summed in another order, the
# bar of tests/test_conv_kernel.py:88 (a share of the largest output), whose
# shapes sum at most 27 x 256 products; a longer sum (Cin = 512) gets the
# square root of its excess, as rounding errors add. With bf16 output, one
# bf16 ulp of the plain result beside that.
K5_REL_TOL = 2e-5
K5_TOL_TERMS = 27 * 256
# What the int8 decode plan of the main-path clip gives K4, largest window:
# (B, Fo, Ho, Wo, Cin, Cout, k_t). The 192x320 padded frame is 96x160
# latents, decoded in 3x4 windows of 34x42; all 9 latents are one frame
# chunk, so a window is 33 frames of 272x336 at the last level. Phases 13 and
# 14 check the logged shapes against this list. The first is the main shape.
CONV_SHAPES = (
    (1, 33, 272, 336, 128, 128, 3),  # up.3 resnets (7 of 17 launches a window)
    (1, 33, 272, 336, 256, 128, 3),  # up.3 first resnet
    (1, 33, 136, 168, 256, 256, 3),  # up.2 resnets
    (1, 33, 272, 336, 256, 256, 1),  # up.2 upsampler, per frame
    (1, 17, 68, 84, 512, 256, 3),  # up.1 first resnet (mode "int8")
    (1, 9, 34, 42, 512, 512, 3),  # mid and up.0 (mode "int8")
    (1, 1, 37, 53, 128, 128, 3),  # ragged: odd Ho and Wo, one frame
)


def log(msg: str) -> None:
    print(msg, flush=True)


def gpu_name_and_limit() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int, warmup: int = 1) -> float:
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def rounded(x, digits: int = 4):
    """x with its floats rounded, dicts and lists included, for a log line."""
    if isinstance(x, float):
        return round(x, digits)
    if isinstance(x, dict):
        return {k: rounded(v, digits) for k, v in x.items()}
    if isinstance(x, list):
        return [rounded(v, digits) for v in x]
    return x


def attn_errors(out: torch.Tensor, ref: torch.Tensor) -> dict:
    diff = out.float() - ref.float()
    ref = ref.float()
    max_abs = float(diff.abs().max())
    return dict(
        max_abs=max_abs,
        rel_max=max_abs / float(ref.abs().max()),
        rel_rms=float(diff.square().mean().sqrt() / ref.square().mean().sqrt()),
    )


def within_bars(err: dict) -> bool:
    return (err["max_abs"] <= K1_ABS_TOL and err["rel_max"] <= K1_REL_MAX_TOL
            and err["rel_rms"] <= K1_REL_RMS_TOL)


def within_grad_bars(err: dict) -> bool:
    """K1's bars for a gradient of any size: the absolute bar, set for
    attention outputs of |o| <= ~3, scales with the gradient's largest value
    past 1. A gradient summed over thousands of rows reaches |x| ~ 8, where
    one bf16 ulp is 0.0625 and two fp32 sums in another order may round to
    neighbours; the relative bars are as K1's."""
    ref_max = err["max_abs"] / err["rel_max"] if err["rel_max"] else 0.0
    return (err["max_abs"] <= K1_ABS_TOL * max(1.0, ref_max)
            and err["rel_max"] <= K1_REL_MAX_TOL and err["rel_rms"] <= K1_REL_RMS_TOL)


def main_path_seq_len(cfg) -> int:
    """Joint text+video tokens of the main path's DiT pass. pad_video pads
    the LQ frame to multiples of 16 (180 rows to 192), so the 32-frame
    180x320 clip's DiT sees 48x80 patches of 5 latent pairs (the 5B), or of
    9 latents (the 2B, no temporal patching)."""
    from dove_tpu_torch import tiling
    from dove_tpu_torch.models.dit import temporal_pad

    pad_f, pad_h, pad_w = tiling.compute_padding(CLIP_FRAMES, CLIP_H, CLIP_W)
    lat = cfg.vae.latent_frames(tiling.next_valid_frames(CLIP_FRAMES + pad_f))
    lat += temporal_pad(cfg.dit, lat)
    patch = cfg.vae.spatial_scale * cfg.dit.patch_size
    h = (CLIP_H + pad_h) * cfg.upscale // patch
    w = (CLIP_W + pad_w) * cfg.upscale // patch
    return cfg.dit.max_text_seq_length + lat // (cfg.dit.patch_size_t or 1) * h * w


def stage2_seq_len(cfg) -> int:
    """Joint text+video tokens of a stage-2 DiT pass: the clip's frames are
    one latent each, padded to patch_size_t (an image's one latent by a copy
    of itself; the 2B pads nothing), so both kinds of step see one latent
    pair of 40x80 latents in 20x40 patches (the 2B: two latents)."""
    from dove_tpu_torch.models.dit import temporal_pad

    lat = S2_FRAMES + temporal_pad(cfg.dit, S2_FRAMES)
    patch = cfg.vae.spatial_scale * cfg.dit.patch_size
    return (cfg.dit.max_text_seq_length
            + lat // (cfg.dit.patch_size_t or 1) * (S2_H // patch) * (S2_W // patch))


def train_seq_len(cfg) -> int:
    """Joint text+video tokens of a stage-1 DiT pass: TRAIN_FRAMES pixel
    frames are 7 latents of 40x80, in 20x40 patches of 4 latent pairs (the
    5B, one copy prepended) or of 7 latents (the 2B)."""
    from dove_tpu_torch.models.dit import temporal_pad

    lat = cfg.vae.latent_frames(TRAIN_FRAMES)
    lat += temporal_pad(cfg.dit, lat)
    patch = cfg.vae.spatial_scale * cfg.dit.patch_size
    return (cfg.dit.max_text_seq_length
            + lat // (cfg.dit.patch_size_t or 1) * (TRAIN_H // patch) * (TRAIN_W // patch))


# ---------------------------------------------------------------------------
# Phase 1: device and build
# ---------------------------------------------------------------------------

# kernel forms by their mangled names. flash_fwd_sm90_kernel<T, QK, kBounded,
# kLse>: T bf16 (13__nv_bfloat16) or fp16 (6__half), QK = T (a substitution,
# S<n>_) for K1 or int8_t (a) for K2; the other templates by their arguments
_FLASH_FWD = re.compile(
    r"flash_fwd_sm90_kernelI(13__nv_bfloat16|6__half)(S\d*_|a)Lb([01])ELb([01])E")
KERNEL_FORMS = {
    "flash_bwd_dq_sm90_kernelI13__nv_bfloat16E": "K3a",
    "flash_bwd_dq_sm90_kernelI6__halfE": "K3a fp16",
    "flash_bwd_dkv_sm90_kernelI13__nv_bfloat16E": "K3b",
    "flash_bwd_dkv_sm90_kernelI6__halfE": "K3b fp16",
    "conv3d_taps_sm90_kernelIaiLi3E": "K4 k_t=3",
    "conv3d_taps_sm90_kernelIaiLi1E": "K4 k_t=1",
    "conv3d_taps_sm90_kernelI13__nv_bfloat16fLi3E": "K5 k_t=3",
    "conv3d_taps_sm90_kernelI13__nv_bfloat16fLi1E": "K5 k_t=1",
    "quant_pack_kernelI13__nv_bfloat16E": "quantizer bf16",
    "quant_pack_kernelI6__halfE": "quantizer fp16",
    "quant_pack_kernelIfE": "quantizer fp32",
    "flash_fwd_sm90_kernel_d128I13__nv_bfloat16E": "K1 d128",
}
SOURCES = ("flash_fwd_sm90", "flash_bwd_sm90", "conv3d_taps_sm90", "conv3d_taps",
           "group_norm_sm90")
# the kernels that must issue wgmma and TMA loads, no mma.sync, and spill
# nothing (K4 and K5 take the output type at run time: one form serves bf16,
# fp16 and fp32 out)
_K1_FORMS = ("bounded", "online", "bounded lse", "online lse")
HOPPER_FORMS = (tuple(f"K1 {f}" for f in _K1_FORMS) + tuple(f"K1 fp16 {f}" for f in _K1_FORMS)
                + ("K2", "K2 fp16", "K3a", "K3b", "K3a fp16", "K3b fp16", "K4 k_t=3",
                   "K4 k_t=1", "K5 k_t=3", "K5 k_t=1", "K1 d128"))
# the forms whose wgmma must be both int8 (Q K^T) and bf16 or fp16 (P V)
MIXED_FORMS = ("K2", "K2 fp16")
# the packages a media route for the CLI could use on the card
MEDIA_PACKAGES = ("PIL", "cv2", "torchvision.io", "av", "imageio")
# what a tokenizer (CLIP-IQA, T5) or NIQE's .mat params could lean on there
TOOL_PACKAGES = ("transformers", "tokenizers", "regex", "ftfy", "scipy.io")
# SASS opcodes counted per kernel form: Hopper's warpgroup MMA (HGMMA on
# floating-point operands, IGMMA on int8), its TMA tensor load (UTMALDG) and
# bulk copy (UBLKCP), and the pre-Hopper mma.sync (HMMA, IMMA)
SASS_OPS = ("HGMMA", "IGMMA", "UTMALDG", "UBLKCP", "HMMA", "IMMA")


def _form(line: str) -> str | None:
    m = _FLASH_FWD.search(line)
    if m:
        fp16 = " fp16" if m.group(1) == "6__half" else ""
        if m.group(2) == "a":
            return "K2" + fp16
        return (f"K1{fp16} {'bounded' if m.group(3) == '1' else 'online'}"
                + (" lse" if m.group(4) == "1" else ""))
    return next((f for key, f in KERNEL_FORMS.items() if key in line), None)


def sass_counts(lib_path) -> dict[str, dict[str, int]] | None:
    """Counts of SASS_OPS in each kernel form of a built library, from
    cuobjdump -sass; None where the toolkit has no cuobjdump."""
    from pathlib import Path

    from dove_tpu_torch import kernels

    tool = Path(kernels._nvcc()).parent / "cuobjdump"
    if not tool.exists():
        return None
    out = subprocess.run([str(tool), "-sass", str(lib_path)], capture_output=True,
                         text=True, check=True, timeout=120).stdout
    counts: dict[str, dict[str, int]] = {}
    form = None
    for line in out.splitlines():
        if "Function :" in line:
            form = _form(line) or line.split("Function :")[1].strip()
            counts[form] = dict.fromkeys(SASS_OPS, 0)
        elif form is not None:
            op = line.split(";")[0].split()
            for tok in op[1:3]:  # the opcode, after an optional predicate
                name = tok.split(".")[0]
                if name in SASS_OPS:
                    counts[form][name] += 1
                    break
    return counts


def import_probe(names) -> dict[str, str]:
    """Which of ``names`` this Python imports: each one's version, or the
    error, from a child process (nothing is loaded into this one)."""
    code = (
        "import importlib, json\n"
        "out = {}\n"
        f"for name in {tuple(names)!r}:\n"
        "    try:\n"
        "        m = importlib.import_module(name)\n"
        "        top = importlib.import_module(name.split('.')[0])\n"
        "        out[name] = 'imports ' + str(getattr(top, '__version__', '?'))\n"
        "    except Exception as e:\n"
        "        out[name] = type(e).__name__ + ': ' + str(e)[:80]\n"
        "print(json.dumps(out))\n"
    )
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120)
    if res.returncode != 0:
        return {"probe": f"failed: {res.stderr.strip()[-200:]}"}
    return json.loads(res.stdout.strip().splitlines()[-1])


def video_probe() -> str:
    """Whether the port's video-file I/O (``io/video.py``, through OpenCV)
    writes an mp4 here and reads it back, in a child process."""
    code = (
        "import numpy as np\n"
        "from dove_tpu_torch.io import video\n"
        "clip = np.linspace(0, 1, 5 * 48 * 64 * 3, dtype=np.float32).reshape(5, 48, 64, 3)\n"
        "path = video.save_video(clip, 'build/video_probe.mp4')\n"
        "back = video.read_video_frames(path)\n"
        "err = float(np.abs(back - clip).max())\n"
        "print(f'{path.name} written as {video._MP4_FOURCC}, {len(back)} of 5 frames "
        "read back, max abs err {err:.3f}')\n"
    )
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120)
    if res.returncode != 0:
        return f"fails: {res.stderr.strip().splitlines()[-1][-160:]}"
    return res.stdout.strip().splitlines()[-1]


def phase_build() -> None:
    import ctypes
    import re
    from concurrent.futures import ThreadPoolExecutor

    from dove_tpu_torch import kernels

    # the probes' child processes run while nvcc builds
    pool = ThreadPoolExecutor(3)
    probes = [pool.submit(import_probe, MEDIA_PACKAGES), pool.submit(import_probe, TOOL_PACKAGES),
              pool.submit(video_probe)]
    t0 = time.perf_counter()
    built = kernels.build_all(list(SOURCES))
    wall = time.perf_counter() - t0
    spills: dict[str, int] = {}
    for name, (seconds, text) in built.items():
        form = "?"
        for line in text.splitlines():
            if "Compiling entry function" in line:
                form = _form(line) or line
            if any(w in line for w in ("registers", "spill", "error", "warning")):
                log(f"  ptxas {name} [{form}]: {line.strip()}")
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
            if m:
                spills[form] = spills.get(form, 0) + int(m.group(1)) + int(m.group(2))
    smem = ctypes.CDLL(str(kernels.library_path("flash_fwd_sm90"))
                       ).dove_flash_fwd_sm90_smem_bytes
    log(f"  K1 (all four forms): {smem(0)} bytes of dynamic shared memory a CTA "
        "(a 192-row Q tile, three stages of 128-key K and V tiles, alignment "
        "slack), 512 threads: producer warpgroup at 24 registers, three "
        f"consumer warpgroups at 160 (setmaxnreg); K2: {smem(1)} bytes (Q and K "
        "as int8 codes in 64-byte rows, V bf16), the same threads and registers")
    bwd_smem = ctypes.CDLL(str(kernels.library_path("flash_bwd_sm90"))
                           ).dove_flash_bwd_sm90_smem_bytes
    log(f"  K3a: {bwd_smem(0)} bytes of dynamic shared memory a CTA (Q and dO of "
        "192 queries, four stages of 64-key K and V tiles, alignment slack), 512 "
        "threads: producer warpgroup at 24 registers, three consumer warpgroups "
        f"at 160; K3b: {bwd_smem(1)} bytes (four stages of 64-query Q and dO "
        "tiles with their lse and delta values; K and V of its 128 keys are "
        "register operands), 384 threads: producer at 24, two consumers at 240")
    conv_smem = ctypes.CDLL(str(kernels.library_path("conv3d_taps_sm90"))
                            ).dove_conv3d_sm90_smem_bytes()
    log(f"  K4 and K5 (all four forms): {conv_smem} bytes of dynamic shared memory a "
        "CTA (three stages of a 384-position halo in three dh pieces and nine "
        "[128 cout, 32 B] weight tiles, the epilogue's per-cout table, alignment "
        "slack), 384 threads: producer "
        "warpgroup at 40 registers, two consumer warpgroups at 232 (setmaxnreg)")
    bad_spills = {f: n for f, n in spills.items() if f in HOPPER_FORMS and n}
    if bad_spills:
        raise AssertionError(f"register spills in {bad_spills}")
    if not all(built[n][1] for n in ("flash_fwd_sm90", "flash_bwd_sm90",
                                     "conv3d_taps_sm90")):
        log("  ptxas: K1/K2, K3 or K4/K5 was built before this run; spills not checked")
    elif not all(f in spills for f in HOPPER_FORMS):
        raise AssertionError(f"no ptxas report for some of {HOPPER_FORMS}: {spills}")
    import shutil

    media, tools, video = (f.result() for f in probes)
    pool.shutdown()
    log(f"  media packages on this machine: {json.dumps(media)}")
    log(f"  tool packages on this machine: {json.dumps(tools)}; "
        f"ffmpeg binary: {shutil.which('ffmpeg')}")
    log(f"  video files through the port's io/video.py: {video}")
    counts = sass_counts(kernels.library_path("flash_fwd_sm90"))
    if counts is None:
        log("  SASS: no cuobjdump in this toolkit; opcode counts not taken")
    else:
        for name in SOURCES:
            lib_counts = (dict(counts) if name == "flash_fwd_sm90"
                          else sass_counts(kernels.library_path(name)))
            for form, c in lib_counts.items():
                log(f"  SASS {name} [{form}]: " + ", ".join(
                    f"{op} {n}" for op, n in c.items()))
            counts.update(lib_counts)
        bad = [f for f in HOPPER_FORMS if f not in counts
               or not (counts[f]["HGMMA"] or counts[f]["IGMMA"])
               or not counts[f]["UTMALDG"] or counts[f]["HMMA"] or counts[f]["IMMA"]]
        bad += [f for f in MIXED_FORMS
                if f in counts and not (counts[f]["HGMMA"] and counts[f]["IGMMA"])]
        if bad:
            raise AssertionError(f"K1, K2, K3a, K3b, K4 or K5 forms without wgmma and "
                                 f"TMA loads, or with mma.sync: {bad}")
    log("phase 1 build: " + ", ".join(
        f"{name} {seconds:.2f}s" for name, (seconds, _) in built.items())
        + f" of nvcc, {wall:.2f}s wall (flash_fwd_sm90: K1 in its four forms and "
        "K2; flash_bwd_sm90: K3a and K3b; "
        "conv3d_taps_sm90: K4 and K5 at k_t = 3 and 1; conv3d_taps: the int8 "
        "quantizer's pass; group_norm_sm90: the VAE's fused GroupNorm)")


# ---------------------------------------------------------------------------
# Phase 2: K1 against its plain version
# ---------------------------------------------------------------------------

# K1's tiles are 192 queries and 128 keys, its TMA maps 3-D over [b*h, S,
# 64]: lengths around the tile edges, B*H = 3 so that every head has
# neighbours on both sides.
RAGGED = (1, 63, 64, 65, 127, 128, 129, 191, 192, 193, 4097)
K1_FORMS = {"bounded": (True, False), "online": (False, False),
            "bounded_lse": (True, True), "online_lse": (False, True)}


def sm_clock_mhz() -> float:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True, timeout=60)
    return float(out.stdout.strip().splitlines()[0])


def k1_edge_cases(with_lse: bool, dtype: torch.dtype = torch.bfloat16) -> dict:
    """K1's bounded and online forms (with_lse: their training forms) in
    ``dtype`` against their plain versions at every (Sq, Skv) of RAGGED, and
    with the neighbouring heads' q, k and v NaN: a tile read across a head's
    end would poison head 1, a store across it would overwrite head 2's NaN."""
    from dove_tpu_torch.ops import flash_attention as fa

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(21 if with_lse else 20)
    worst = dict(max_abs=0.0, rel_max=0.0, rel_rms=0.0, lse=0.0)

    def check(out, ref, what):
        (out, lse), (ref, ref_lse) = (out, ref) if with_lse else ((out, None), (ref, None))
        err = attn_errors(out, ref)
        lse_err = float((lse - ref_lse).abs().max()) if with_lse else 0.0
        if (not bool(torch.isfinite(out).all()) or not within_bars(err)
                or not lse_err <= K1_LSE_ABS_TOL):
            raise AssertionError(f"K1 disagrees with its plain version at {what}: "
                                 f"{err}, lse {lse_err}")
        for key in ("max_abs", "rel_max", "rel_rms"):
            worst[key] = max(worst[key], err[key])
        worst["lse"] = max(worst["lse"], lse_err)

    def rand(s):
        return torch.randn((1, 3, s, 64), generator=gen, device=dev, dtype=dtype)

    for sq in RAGGED:
        for skv in RAGGED:
            q, k, v = rand(sq), rand(skv), rand(skv)
            for bounded in (True, False):
                out = fa.flash_attention(q, k, v, bounded_logits=bounded, with_lse=with_lse)
                torch.cuda.synchronize()
                check(out, fa.flash_attention_plain(q, k, v, bounded_logits=bounded,
                                                    with_lse=with_lse),
                      f"sq={sq} skv={skv} bounded={bounded}")
    for sq, skv in ((129, 193), (4097, 129)):
        q, k, v = rand(sq), rand(skv), rand(skv)
        for t in (q, k, v):
            t[:, 0::2] = float("nan")
        mid = [t[:, 1:2].contiguous() for t in (q, k, v)]
        for bounded in (True, False):
            out = fa.flash_attention(q, k, v, bounded_logits=bounded, with_lse=with_lse)
            torch.cuda.synchronize()
            o = out[0] if with_lse else out
            if not bool(torch.isnan(o[:, 0::2].float()).all()):
                raise AssertionError(f"K1 wrote into a NaN head's output at sq={sq}")
            head1 = (o[:, 1:2], out[1][:, 1:2].contiguous()) if with_lse else o[:, 1:2]
            check(head1, fa.flash_attention_plain(*mid, bounded_logits=bounded,
                                                  with_lse=with_lse),
                  f"NaN neighbours sq={sq} skv={skv} bounded={bounded}")
    cases = len(RAGGED) ** 2 * 2 + 4
    log(f"  K1 {'training' if with_lse else 'inference'} forms ({dtype}) at every "
        "Sq, Skv in "
        f"{RAGGED} (B*H = 3) and beside NaN heads: {cases} launches within the bars; "
        "worst " + json.dumps({k: float(f"{x:.3e}") for k, x in worst.items()}))
    return worst


def time_k1_forms(q, k, v) -> dict:
    """Each K1 form's time, SDPA's time on the same tensors (timed after and
    before the kernels), the SM clock the card ran at, and the exp floor:
    Sq Skv B H exponentials at 16 a clock on each SM at that clock."""
    from dove_tpu_torch.ops import flash_attention as fa

    B, H, sq, _ = q.shape
    skv = k.shape[2]
    scale = 64 ** -0.5
    sdpa = torch.nn.functional.scaled_dot_product_attention
    sdpa_before = cuda_ms(lambda: sdpa(q, k, v), 10)
    forms = {name: cuda_ms(lambda b=b, lse=lse: fa.flash_fwd_launch(q, k, v, scale, b, lse), 10)
             for name, (b, lse) in K1_FORMS.items()}
    clock = sm_clock_mhz()
    sdpa_ms = min(sdpa_before, cuda_ms(lambda: sdpa(q, k, v), 10))
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    exp_floor = float(sq) * skv * B * H / (16 * sms * clock * 1e6) * 1e3
    return dict(forms_ms=forms, sdpa_ms=sdpa_ms,
                sdpa_ratio={n: t / sdpa_ms for n, t in forms.items()},
                sm_clock_mhz=clock, exp_floor_ms=exp_floor)


def phase_k1(seq_main: int, heads: int) -> dict:
    from dove_tpu_torch.ops import flash_attention as fa

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    worst = 0.0
    timing = None
    for S in (seq_main, 4097, 200):
        q, k, v = (
            torch.randn((1, heads, S, 64), generator=gen, device=dev,
                        dtype=torch.bfloat16)
            for _ in range(3)
        )
        for bounded in (True, False):
            out = fa.flash_attention(q, k, v, bounded_logits=bounded)
            torch.cuda.synchronize()
            ref = fa.flash_attention_plain(q, k, v, bounded_logits=bounded)
            err = attn_errors(out, ref)
            finite = bool(torch.isfinite(out).all())
            log(f"  K1 S={S} bounded={bounded}: max_abs_err {err['max_abs']:.3e}, "
                f"/ max|ref| {err['rel_max']:.3e}, rms err / rms ref "
                f"{err['rel_rms']:.3e} (ref rms "
                f"{float(ref.float().square().mean().sqrt()):.3e}), finite {finite}")
            if not finite or not within_bars(err):
                raise AssertionError(
                    f"K1 disagrees with its plain version: S={S} "
                    f"bounded={bounded} {err}")
            worst = max(worst, err["max_abs"])
        if S == seq_main:
            # the bars must reject a kernel that drops one 64-key tile
            dropped = fa.flash_attention_plain(
                q, k[:, :, 64:].contiguous(), v[:, :, 64:].contiguous(),
                bounded_logits=False)
            miss = attn_errors(dropped, ref)
            log(f"  bar check: one 64-key tile dropped at S={S} gives "
                f"rms err / rms ref {miss['rel_rms']:.3e}, rejected "
                f"{not within_bars(miss)}")
            if within_bars(miss):
                raise AssertionError(f"K1 bars accept a dropped KV tile: {miss}")
            del dropped
            forms = time_k1_forms(q, k, v)
            plain_ms = cuda_ms(
                lambda: fa.flash_attention_plain(q, k, v, bounded_logits=True),
                1, warmup=0)
            flops = 4.0 * S * S * 64 * heads
            nbytes = 4 * heads * S * 64 * 2
            bound_ms = max(flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES) * 1e3
            kernel_ms = forms["forms_ms"]["bounded"]
            timing = dict(
                kernel_ms=kernel_ms, unbounded_ms=forms["forms_ms"]["online"],
                plain_ms=plain_ms, library_ms=forms["sdpa_ms"], bound_ms=bound_ms,
                bound_by="operations" if flops / PEAK_BF16_FLOPS
                >= nbytes / PEAK_BYTES else "bytes",
                tflops=flops / kernel_ms / 1e9, shape=[1, heads, S, 64], **forms,
            )
        del q, k, v
    edges = k1_edge_cases(with_lse=False)
    fa.launches.reset()
    fa.launches_lse.reset()
    log(f"phase 2 K1: worst max_abs_err {worst:.3e} (bars: abs {K1_ABS_TOL}, "
        f"/ max|ref| {K1_REL_MAX_TOL}, rms ratio {K1_REL_RMS_TOL}); "
        + json.dumps(rounded(timing)))
    return dict(max_abs_err=max(worst, edges["max_abs"]), **timing)


# ---------------------------------------------------------------------------
# Phase 3: the slice through the kernel and through the plain attention
# ---------------------------------------------------------------------------

def _pipeline(cfg, dit, vae, backend: str | None, sample_posterior: bool,
              quantize: str | None = None, **flags):
    from dove_tpu_torch.pipeline import DovePipeline

    prompt = torch.zeros((cfg.dit.max_text_seq_length, cfg.dit.text_embed_dim),
                         dtype=torch.bfloat16)
    return DovePipeline(
        config=cfg, dit=dit, vae=vae, prompt_embedding=prompt,
        dtype=torch.bfloat16, device="cuda", attention_backend=backend,
        sample_posterior=sample_posterior, vae_tiling=True, output_uint8=True,
        quantize=quantize, **flags,
    )


def psnr_u8(a: np.ndarray, b: np.ndarray) -> float:
    mse = float(np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2))
    return float("inf") if mse == 0 else 10.0 * math.log10(255.0**2 / mse)


def phase_kernel_vs_plain_pipeline() -> None:
    """Full widths (48x64 heads, the full VAE), 2 DiT layers, a 9-frame
    96x160 clip: 2146 joint tokens, so the automatic dispatch takes K1."""
    import dataclasses

    from dove_tpu_torch import cogvideox1_5_5b, init_dit_params, init_vae_params
    from dove_tpu_torch.ops import flash_attention as fa

    base = cogvideox1_5_5b()
    cfg = dataclasses.replace(base, dit=dataclasses.replace(base.dit, num_layers=2))
    dit = init_dit_params(cfg.dit, seed=0, device="cuda", dtype=torch.bfloat16)
    vae = init_vae_params(cfg.vae, seed=1, device="cuda", dtype=torch.bfloat16)
    clip = np.random.default_rng(3).uniform(0, 1, (9, 96, 160, 3)).astype(np.float32)
    outs = {}
    for backend in (None, "plain"):
        pipe = _pipeline(cfg, dit, vae, backend, sample_posterior=False)
        fa.launches.reset()
        out = pipe.process_frames(clip, seed=0)
        outs[backend] = (out, fa.launches.count, dict(pipe.stage_times))
    (k_out, k_launch, k_times), (p_out, p_launch, _) = outs[None], outs["plain"]
    if k_out.shape != (9, 384, 640, 3) or k_out.dtype != np.uint8:
        raise AssertionError(f"phase 3 output {k_out.shape} {k_out.dtype}")
    if k_launch != cfg.dit.num_layers or p_launch != 0:
        raise AssertionError(
            f"phase 3 launches: kernel run {k_launch}, plain run {p_launch}")
    psnr = psnr_u8(k_out, p_out)
    max_diff = int(np.abs(k_out.astype(int) - p_out.astype(int)).max())
    log(f"phase 3 kernel vs plain pipeline (2 layers, full width): PSNR "
        f"{psnr:.2f} dB (bar {PSNR_BAR_DB}), max |diff| {max_diff} LSB, "
        f"launches {k_launch}, output std {float(k_out.std()):.2f}, "
        f"stages {json.dumps({k: round(v, 3) for k, v in k_times.items()})}")
    if not psnr >= PSNR_BAR_DB:
        raise AssertionError(f"phase 3 PSNR {psnr} below {PSNR_BAR_DB}")
    del dit, vae
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# Phase 4: the main path, CogVideoX1.5-5B at full width and depth
# ---------------------------------------------------------------------------

def phase_main_path(profile_dir: str | None = None) -> dict:
    from dove_tpu_torch import cogvideox1_5_5b, init_dit_params, init_vae_params
    from dove_tpu_torch.ops import flash_attention as fa

    cfg = cogvideox1_5_5b()
    t0 = time.perf_counter()
    dit = init_dit_params(cfg.dit, seed=0, device="cuda", dtype=torch.bfloat16)
    vae = init_vae_params(cfg.vae, seed=1, device="cuda", dtype=torch.bfloat16)
    pipe = _pipeline(cfg, dit, vae, None, sample_posterior=True)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in dit.parameters())
    clip = np.random.default_rng(4).uniform(
        0, 1, (CLIP_FRAMES, CLIP_H, CLIP_W, 3)).astype(np.float32)

    torch.cuda.reset_peak_memory_stats()
    fa.launches.reset()
    fa.launches_qk8.reset()
    t0 = time.perf_counter()
    out = pipe.process_frames(clip, seed=0)
    wall = time.perf_counter() - t0
    launches, launches_k2 = fa.launches.count, fa.launches_qk8.count
    peak = torch.cuda.max_memory_allocated()

    expect = (CLIP_FRAMES, CLIP_H * cfg.upscale, CLIP_W * cfg.upscale, 3)
    if out.shape != expect or out.dtype != np.uint8:
        raise AssertionError(f"main path output {out.shape} {out.dtype}, want {expect}")
    if float(out.std()) == 0.0:
        raise AssertionError("main path output is constant")
    if launches != cfg.dit.num_layers or launches_k2:  # one DiT pass, bf16
        raise AssertionError(f"K1 launches {launches}, want {cfg.dit.num_layers}; "
                             f"K2 launches {launches_k2}, want 0")
    times = {k: round(v, 3) for k, v in pipe.stage_times.items()}
    log(f"phase 4 main path (5B, {cfg.dit.num_layers} layers, "
        f"{n_params / 1e9:.2f}B DiT params, bf16): output {out.shape} uint8, "
        f"wall {wall:.2f}s, stages {json.dumps(times)}, K1 launches {launches}, "
        f"peak {peak / 2**30:.2f} GiB, weights init {init_s:.1f}s")
    if profile_dir is not None:
        profile_main_path(pipe, clip, profile_dir)
    return dict(launches=launches, stage_s=times, wall_s=wall, peak_bytes=peak, out=out)


KERNEL_KINDS = (  # (kind, substrings of CUDA kernel names), first match wins
    ("k2_flash_fwd_qk8", ("flash_fwd_sm90_kernel<__nv_bfloat16, signed char",
                          "flash_fwd_sm90_kernel<__half, signed char")),
    ("k1_flash_fwd", ("flash_fwd_sm90_kernel",)),
    ("k3a_flash_bwd_dq", ("flash_bwd_dq_sm90_kernel",)),
    ("k3b_flash_bwd_dkv", ("flash_bwd_dkv_sm90_kernel",)),
    ("k4_conv3d_w8a8", ("conv3d_taps_sm90_kernel<signed char",
                        "conv3d_taps_sm90_kernel<int8")),
    ("k5_conv3d_bf16", ("conv3d_taps_sm90_kernel<__nv_bfloat16",)),
    ("quant_pack", ("quant_pack_kernel",)),
    ("group_norm", ("rowwisemoments", "group_norm", "groupnorm")),
    ("conv_layout", ("nchwtonhwc", "nhwctonchw")),
    ("conv", ("fprop", "conv", "implicit_gemm", "cudnn")),
    ("int8_gemm", ("i16832gemm", "s8s8", "i8i8", "imma")),  # torch._int_mm
    ("gemm", ("gemm", "nvjet", "cutlass")),
    ("cat_copy_index", ("catarray", "copy", "index", "gather", "memcpy", "memset")),
    ("elementwise", ("elementwise", "reduce", "layer_norm")),
)


def _merged_busy(intervals: list[tuple[float, float]]) -> float:
    busy, end = 0.0, float("-inf")
    for a, b in sorted(intervals):
        if b > end:
            busy += b - max(a, end)
            end = b
    return busy


def profile_main_path(pipe, clip: np.ndarray, out_dir: str,
                      name: str = "main_path", phase: str = "phase 4") -> None:
    def run() -> dict:
        pipe.process_frames(clip, seed=0)
        return pipe.stage_times

    profile_run(run, out_dir, name, phase)


def profile_run(run, out_dir: str, name: str, phase: str) -> None:
    """A warm unprofiled ``run()`` (which returns its stage times) for
    steady-state stage times, then one run under torch.profiler. From the
    exported trace's kernel events: the device's busy and idle share, device
    time by kernel kind, and busy time inside each named range ("dove.enc",
    "dove.train.encode", ...). The key_averages table goes to
    <out_dir>/<name>_profile.txt."""
    from pathlib import Path

    from torch.profiler import ProfilerActivity, profile

    t0 = time.perf_counter()
    stages = run()
    warm = time.perf_counter() - t0
    warm_stages = {k: round(v, 3) for k, v in stages.items()}
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        prof_wall = time.perf_counter() - t0
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    (out / f"{name}_profile.txt").write_text(
        prof.key_averages().table(sort_by="self_device_time_total", row_limit=40))
    trace_path = out / f"{name}_trace.json"
    prof.export_chrome_trace(str(trace_path))
    events = json.loads(trace_path.read_text())["traceEvents"]
    trace_path.unlink()  # tens of MB; the summary below is what is kept
    kernels = [e for e in events
               if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
    spans = [(float(e["ts"]), float(e["ts"]) + float(e["dur"])) for e in kernels]
    window = max(b for _, b in spans) - min(a for a, _ in spans)
    busy = _merged_busy(spans)
    by_kind: dict[str, float] = {}
    for e in kernels:
        name = e["name"].lower()
        kind = next((k for k, subs in KERNEL_KINDS if any(x in name for x in subs)),
                    "other")
        by_kind[kind] = by_kind.get(kind, 0.0) + float(e["dur"])
    by_stage = {}
    starts, ends = (np.array(v) for v in zip(*spans))
    for e in events:
        if e.get("cat") == "gpu_user_annotation" and e["name"].startswith("dove."):
            a, b = float(e["ts"]), float(e["ts"]) + float(e["dur"])
            hit = np.nonzero((ends > a) & (starts < b))[0]
            inside = [(max(starts[i], a), min(ends[i], b)) for i in hit]
            # a range entered many times (the quantizer of every int8 conv)
            # adds up
            tot = by_stage.setdefault(e["name"], {"span_s": 0.0, "busy_s": 0.0, "n": 0})
            tot["span_s"] += (b - a) / 1e6
            tot["busy_s"] += _merged_busy(inside) / 1e6
            tot["n"] += 1
    for tot in by_stage.values():
        tot["span_s"], tot["busy_s"] = round(tot["span_s"], 3), round(tot["busy_s"], 3)
    log(f"{phase} profile: warm wall {warm:.2f}s stages {json.dumps(warm_stages)}; "
        f"profiled wall {prof_wall:.2f}s, {len(kernels)} kernels, device busy "
        f"{busy / 1e6:.3f}s of a {window / 1e6:.3f}s kernel window "
        f"(idle {100 * (1 - busy / window):.1f}%), by stage {json.dumps(by_stage)}, "
        "by kind (s) " + json.dumps(
            {k: round(v / 1e6, 3) for k, v in sorted(by_kind.items(),
                                                     key=lambda kv: -kv[1])}))


# ---------------------------------------------------------------------------
# Phase 5: K2 against its plain version
# ---------------------------------------------------------------------------

def k2_edge_cases(dtype: torch.dtype = torch.bfloat16) -> dict:
    """K2 against its plain version at every (Sq, Skv) of RAGGED (B*H = 3), and beside a poisoned head: int8 codes carry no
    NaN, so head 1's K codes are all 127 (logits far past any other) and its
    V is NaN. A K or V tile read across a head's end would carry them into
    heads 0 or 2, a store across it would overwrite head 1's NaN output."""
    from dove_tpu_torch.ops import flash_attention as fa

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(22)
    scale = 64 ** -0.5
    worst = dict(max_abs=0.0, rel_max=0.0, rel_rms=0.0)

    def rand(s):  # q, k and V in the model type; q and k go in as codes
        return torch.randn((1, 3, s, 64), generator=gen, device=dev, dtype=dtype)

    def run(q8, k8, v, factor, ref, what, heads=slice(None)):
        out = fa.flash_qk8_launch(q8, k8, v, factor)
        torch.cuda.synchronize()
        err = attn_errors(out[:, heads], ref)
        if not bool(torch.isfinite(out[:, heads]).all()) or not within_bars(err):
            raise AssertionError(f"K2 disagrees with its plain version at {what}: {err}")
        for key in worst:
            worst[key] = max(worst[key], err[key])
        return out

    for sq in RAGGED:
        for skv in RAGGED:
            q, k, v = rand(sq), rand(skv), rand(skv)
            q8, k8, factor = fa.quantize_qk_pair(q, k, scale)
            ref = fa.flash_attention_qk8_plain(q8, k8, v, factor)
            run(q8, k8, v, factor, ref, f"sq={sq} skv={skv}")
    for sq, skv in ((129, 193), (193, 65), (4097, 129)):
        q, k, v = rand(sq), rand(skv), rand(skv)
        q8, k8, factor = fa.quantize_qk_pair(q, k, scale)
        k8[:, 1] = 127
        v[:, 1] = float("nan")
        ends = [t[:, 0::2].contiguous() for t in (q8, k8, v)]
        ref = fa.flash_attention_qk8_plain(*ends, factor)
        out = run(q8, k8, v, factor, ref, f"poisoned head 1 sq={sq} skv={skv}",
                  heads=slice(0, None, 2))
        if not bool(torch.isnan(out[:, 1].float()).all()):
            raise AssertionError(f"K2 wrote into the poisoned head's output at sq={sq}")
    cases = len(RAGGED) ** 2 + 3
    log(f"  K2 ({dtype} V and O) at every Sq, Skv in {RAGGED} (B*H = 3) and beside "
        "a poisoned head "
        f"(K codes 127, V NaN): {cases} launches within the bars, "
        "the poisoned head's output NaN; worst "
        + json.dumps({k: float(f"{x:.3e}") for k, x in worst.items()}))
    return worst


def phase_k2(seq_main: int, heads: int) -> dict:
    from dove_tpu_torch.ops import flash_attention as fa

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1)
    scale = 64 ** -0.5
    worst = worst_drift = 0.0
    timing = None
    for S in (seq_main, 4097, 200):
        q, k, v = (
            torch.randn((1, heads, S, 64), generator=gen, device=dev,
                        dtype=torch.bfloat16)
            for _ in range(3)
        )
        out = fa.flash_attention(q, k, v, bounded_logits=True, qk_int8=True)
        torch.cuda.synchronize()
        q8, k8, factor = fa.quantize_qk_pair(q, k, scale)
        ref = fa.flash_attention_qk8_plain(q8, k8, v, factor)
        err = attn_errors(out, ref)
        drift = attn_errors(out, fa.flash_attention(q, k, v, bounded_logits=True))
        finite = bool(torch.isfinite(out).all())
        log(f"  K2 S={S}: max_abs_err {err['max_abs']:.3e}, / max|ref| "
            f"{err['rel_max']:.3e}, rms err / rms ref {err['rel_rms']:.3e}; "
            f"finite {finite}; drift from K1 (int8 Q K^T): "
            f"rms {drift['rel_rms']:.3e} (bar {K2_DRIFT_TOL}), max_abs "
            f"{drift['max_abs']:.3e}")
        if not finite or not within_bars(err):
            raise AssertionError(f"K2 disagrees with its plain version: S={S} {err}")
        if not drift["rel_rms"] <= K2_DRIFT_TOL:
            raise AssertionError(f"K2 drifts from K1 by {drift} at S={S}")
        worst = max(worst, err["max_abs"])
        worst_drift = max(worst_drift, drift["rel_rms"])
        if S == seq_main:
            dropped = fa.flash_attention_qk8_plain(
                q8, k8[:, :, 64:].contiguous(), v[:, :, 64:].contiguous(), factor)
            miss = attn_errors(dropped, ref)
            log(f"  bar check: one 64-key tile dropped at S={S} gives "
                f"rms err / rms ref {miss['rel_rms']:.3e}, rejected "
                f"{not within_bars(miss)}")
            if within_bars(miss):
                raise AssertionError(f"K2 bars accept a dropped KV tile: {miss}")
            del dropped

            # K2 and K1 bounded by one rule: K2_WINDOWS 10-launch windows
            # each, in turns, and the median of each; the clock moves within
            # a call, so one window of each would compare two clocks
            k2_windows, k1_windows = [], []
            for _ in range(K2_WINDOWS):
                k2_windows.append(cuda_ms(lambda: fa.flash_qk8_launch(q8, k8, v, factor), 10))
                k1_windows.append(cuda_ms(
                    lambda: fa.flash_attention(q, k, v, bounded_logits=True), 10))
            kernel_ms = statistics.median(k2_windows)
            k1_ms = statistics.median(k1_windows)
            clock = sm_clock_mhz()
            quantize_ms = cuda_ms(lambda: fa.quantize_qk_pair(q, k, scale), 10)
            wrapper_ms = cuda_ms(lambda: fa.flash_attention(
                q, k, v, bounded_logits=True, qk_int8=True), 10)
            plain_ms = cuda_ms(
                lambda: fa.flash_attention_qk8_plain(q8, k8, v, factor), 1, warmup=0)
            sdpa_ms = cuda_ms(
                lambda: torch.nn.functional.scaled_dot_product_attention(
                    q, k, v), 10)
            # Q K^T in int8, P V in bf16: 2 S^2 D H operations each; reads
            # int8 q and k and bf16 v once, writes bf16 out once
            macs = float(S) * S * 64 * heads
            ops_s = 2 * macs / PEAK_INT8_OPS + 2 * macs / PEAK_BF16_FLOPS
            nbytes = heads * S * 64 * (1 + 1 + 2 + 2)
            sms = torch.cuda.get_device_properties(0).multi_processor_count
            timing = dict(
                kernel_ms=kernel_ms, kernel_windows_ms=k2_windows,
                k1_same_call_ms=k1_ms, k1_windows_ms=k1_windows,
                quantize_ms=quantize_ms, wrapper_ms=wrapper_ms,
                plain_ms=plain_ms, sdpa_ms=sdpa_ms,
                bound_ms=max(ops_s, nbytes / PEAK_BYTES) * 1e3,
                bound_by="operations" if ops_s >= nbytes / PEAK_BYTES else "bytes",
                exp_floor_ms=float(S) * S * heads / (16 * sms * clock * 1e6) * 1e3,
                sm_clock_mhz=clock, shape=[1, heads, S, 64],
            )
        del q, k, v, q8, k8, out, ref
    edges = k2_edge_cases()
    fa.launches.reset()
    fa.launches_qk8.reset()
    log(f"phase 5 K2: worst max_abs_err {worst:.3e} (K1's bars), worst drift "
        f"from K1 {worst_drift:.3e}; kernel_ms and k1_same_call_ms are the "
        f"medians of {K2_WINDOWS} interleaved 10-launch windows each; quantize_ms "
        "is quantize_qk_pair alone (amax and quantize over q and k), wrapper_ms "
        "the quantizer and K2 together; SDPA is bf16 attention, a yardstick of "
        "a different function; "
        + json.dumps(rounded(timing)))
    return dict(max_abs_err=max(worst, edges["max_abs"]), **timing)


# ---------------------------------------------------------------------------
# Phase 6: the int8-dit slice through K2 and through its plain version
# ---------------------------------------------------------------------------

def phase_k2_pipeline() -> None:
    """Phase 3's model and clip with quantize="int8-dit": the automatic
    backend on the card is K2 for every attention; "plain-qk8" is its plain
    version. Both runs share the DiT, quantized in place by the first."""
    import dataclasses

    from dove_tpu_torch import cogvideox1_5_5b, init_dit_params, init_vae_params
    from dove_tpu_torch.ops import flash_attention as fa

    base = cogvideox1_5_5b()
    cfg = dataclasses.replace(base, dit=dataclasses.replace(base.dit, num_layers=2))
    dit = init_dit_params(cfg.dit, seed=0, device="cuda", dtype=torch.bfloat16)
    vae = init_vae_params(cfg.vae, seed=1, device="cuda", dtype=torch.bfloat16)
    clip = np.random.default_rng(3).uniform(0, 1, (9, 96, 160, 3)).astype(np.float32)
    outs = {}
    for backend in (None, "plain-qk8"):
        pipe = _pipeline(cfg, dit, vae, backend, sample_posterior=False,
                         quantize="int8-dit")
        if backend is None and pipe.attention_backend != "flash-qk8":
            raise AssertionError(f"int8-dit on the card chose {pipe.attention_backend}")
        fa.launches.reset()
        fa.launches_qk8.reset()
        out = pipe.process_frames(clip, seed=0)
        outs[backend] = (out, fa.launches_qk8.count, fa.launches.count,
                         dict(pipe.stage_times))
    (k_out, k_launch, k_k1, k_times) = outs[None]
    (p_out, p_launch, p_k1, _) = outs["plain-qk8"]
    if k_out.shape != (9, 384, 640, 3) or k_out.dtype != np.uint8:
        raise AssertionError(f"phase 6 output {k_out.shape} {k_out.dtype}")
    if (k_launch, k_k1, p_launch, p_k1) != (cfg.dit.num_layers, 0, 0, 0):
        raise AssertionError(
            f"phase 6 launches: K2 run {k_launch} K2 + {k_k1} K1, plain run "
            f"{p_launch} K2 + {p_k1} K1")
    psnr = psnr_u8(k_out, p_out)
    max_diff = int(np.abs(k_out.astype(int) - p_out.astype(int)).max())
    log(f"phase 6 K2 vs plain-qk8 int8-dit pipeline (2 layers, full width): "
        f"PSNR {psnr:.2f} dB (bar {PSNR_BAR_DB}), max |diff| {max_diff} LSB, "
        f"K2 launches {k_launch}, K1 launches {k_k1}, output std "
        f"{float(k_out.std()):.2f}, stages "
        f"{json.dumps({k: round(v, 3) for k, v in k_times.items()})}")
    if not psnr >= PSNR_BAR_DB:
        raise AssertionError(f"phase 6 PSNR {psnr} below {PSNR_BAR_DB}")
    del dit, vae, pipe
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# Phases 7 and 8: the int8-dit main path, single pass and streamed
# ---------------------------------------------------------------------------

def _drive_int8(pipe, cfg, frames: int, want_k2: int, seed: int,
                profile_dir: str | None = None) -> dict:
    """One clip through process_frames with both counters at 0 before it;
    fails unless K2 ran want_k2 times, K1 never, and the output is a
    non-constant uint8 clip of the right shape."""
    from dove_tpu_torch.ops import flash_attention as fa

    clip = np.random.default_rng(seed).uniform(
        0, 1, (frames, CLIP_H, CLIP_W, 3)).astype(np.float32)
    torch.cuda.reset_peak_memory_stats()
    fa.launches.reset()
    fa.launches_qk8.reset()
    t0 = time.perf_counter()
    out = pipe.process_frames(clip, seed=0)
    wall = time.perf_counter() - t0
    k2, k1 = fa.launches_qk8.count, fa.launches.count
    peak = torch.cuda.max_memory_allocated()
    expect = (frames, CLIP_H * cfg.upscale, CLIP_W * cfg.upscale, 3)
    if out.shape != expect or out.dtype != np.uint8:
        raise AssertionError(f"int8-dit output {out.shape} {out.dtype}, want {expect}")
    if float(out.std()) == 0.0:
        raise AssertionError("int8-dit output is constant")
    if k2 != want_k2 or k1:
        raise AssertionError(f"K2 launches {k2}, want {want_k2}; K1 launches {k1}, want 0")
    result = dict(launches=k2, wall_s=wall, peak_bytes=peak,
                  stage_s={k: round(v, 3) for k, v in pipe.stage_times.items()})
    if profile_dir is not None:
        profile_main_path(pipe, clip, profile_dir, "int8_main_path", "phase 7")
    return result


def phase_int8_paths(profile_dir: str | None = None) -> tuple[dict, dict]:
    from dove_tpu_torch import cogvideox1_5_5b, init_dit_params, init_vae_params, tiling
    from dove_tpu_torch.pipeline import plan_dit_windows

    cfg = cogvideox1_5_5b()
    t0 = time.perf_counter()
    dit = init_dit_params(cfg.dit, seed=0, device="cuda", dtype=torch.bfloat16)
    vae = init_vae_params(cfg.vae, seed=1, device="cuda", dtype=torch.bfloat16)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    bf16_bytes = sum(t.nbytes for t in (*dit.parameters(), *dit.buffers()))
    t0 = time.perf_counter()
    pipe = _pipeline(cfg, dit, vae, None, sample_posterior=True, quantize="int8-dit")
    torch.cuda.synchronize()
    quant_s = time.perf_counter() - t0
    del dit
    int8_bytes = sum(t.nbytes for t in (*pipe.dit.parameters(), *pipe.dit.buffers()))
    if pipe.attention_backend != "flash-qk8":
        raise AssertionError(f"int8-dit on the card chose {pipe.attention_backend}")
    layers = cfg.dit.num_layers

    main = _drive_int8(pipe, cfg, CLIP_FRAMES, layers, seed=4, profile_dir=profile_dir)
    log(f"phase 7 int8-dit main path (5B, {layers} layers, W8A8 DiT "
        f"{int8_bytes / 2**30:.2f} GiB from {bf16_bytes / 2**30:.2f} GiB bf16, "
        f"quantized on the card in {quant_s:.1f}s, weights init {init_s:.1f}s): "
        f"{CLIP_FRAMES} frames -> {CLIP_H * cfg.upscale}x{CLIP_W * cfg.upscale}, "
        f"wall {main['wall_s']:.2f}s, stages {json.dumps(main['stage_s'])}, "
        f"K2 launches {main['launches']}, K1 launches 0, "
        f"peak {main['peak_bytes'] / 2**30:.2f} GiB")

    padded = tiling.next_valid_frames(STREAM_FRAMES + tiling.compute_padding(
        STREAM_FRAMES, CLIP_H, CLIP_W)[0])
    n_lat = cfg.vae.latent_frames(padded)
    windows = len(plan_dit_windows(n_lat, pipe.dit_window_latents,
                                   pipe.dit_overlap_latents))
    streamed_calls = []
    run = pipe._sr_clip_streamed
    pipe._sr_clip_streamed = lambda *a, **kw: streamed_calls.append(1) or run(*a, **kw)
    streamed = _drive_int8(pipe, cfg, STREAM_FRAMES, layers * windows, seed=5)
    del pipe._sr_clip_streamed  # the wrapper's cycle would keep the pipeline alive
    if streamed_calls != [1]:
        raise AssertionError("the long clip did not take the streamed path")
    log(f"phase 8 streamed int8-dit: {STREAM_FRAMES} frames ({padded} padded, "
        f"{n_lat} latents, {windows} DiT windows), wall {streamed['wall_s']:.2f}s, "
        f"stages {json.dumps(streamed['stage_s'])}, K2 launches "
        f"{streamed['launches']}, K1 launches 0, peak "
        f"{streamed['peak_bytes'] / 2**30:.2f} GiB")
    return main, streamed


# ---------------------------------------------------------------------------
# Phase 9: the training attention, K1 with the logsumexp, K3a and K3b
# ---------------------------------------------------------------------------

def _k3_counters():
    from dove_tpu_torch.ops import flash_attention as fa

    return {"k1": fa.launches, "k1_lse": fa.launches_lse, "k2": fa.launches_qk8,
            "k3a": fa.launches_bwd_dq, "k3b": fa.launches_bwd_dkv}


def _bound(flops: float, nbytes: float) -> tuple[float, str]:
    ops_s, bytes_s = flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES
    return max(ops_s, bytes_s) * 1e3, "operations" if ops_s >= bytes_s else "bytes"


def k3_edge_cases(dtype: torch.dtype = torch.bfloat16) -> dict:
    """K3a and K3b against their plain versions at every (Sq, Skv) of RAGGED
    with B*H = 3, on the output and logsumexp of both K1 training forms; and
    with the neighbouring heads' q, k, v, dO, lse and delta NaN: a tile read
    across a head's end would poison head 1 (K3b's lse and delta slices may
    read the next head's values, which its last tile must mask), a store
    across it would overwrite a NaN head's gradients."""
    from dove_tpu_torch.ops import flash_attention as fa

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(22)
    scale = 64 ** -0.5
    worst = {"k3a": 0.0, "k3b": 0.0}

    def rand(s):
        return torch.randn((1, 3, s, 64), generator=gen, device=dev, dtype=dtype)

    def inputs(sq, skv, bounded):
        q, k, v, do = rand(sq), rand(skv), rand(skv), rand(sq)
        out, lse = fa.flash_attention(q, k, v, bounded_logits=bounded, with_lse=True)
        return [q, k, v, do, lse, (do.float() * out.float()).sum(-1)]

    def check(args, heads: slice, what: str):
        grads = (fa.flash_bwd_dq_launch(*args, scale),
                 *fa.flash_bwd_dkv_launch(*args, scale))
        torch.cuda.synchronize()
        mid = [t[:, heads].contiguous() for t in args]
        refs = (fa.flash_bwd_dq_plain(*mid, scale), *fa.flash_bwd_dkv_plain(*mid, scale))
        one_key = args[1].shape[2] == 1
        for key, name, got, want in zip(("k3a", "k3b", "k3b"), "qkv", grads, refs):
            got = got[:, heads]
            err = attn_errors(got, want)
            if (one_key and name != "v"
                    and float(want.float().abs().max()) <= ZERO_GRAD_TOL):
                # one key, online form: p = 1 and o = v, so ds = dO.v - delta
                # and dQ, dK are 0; both sides hold only rounding residue
                ok = float(got.float().abs().max()) <= ZERO_GRAD_TOL
            else:
                ok = within_grad_bars(err)
            if not bool(torch.isfinite(got).all()) or not ok:
                raise AssertionError(f"{key} d{name} disagrees with its plain version "
                                     f"at {what}: {err}")
            worst[key] = max(worst[key], err["max_abs"])
        return grads

    for sq in RAGGED:
        for skv in RAGGED:
            for bounded in (True, False):
                check(inputs(sq, skv, bounded), slice(None),
                      f"sq={sq} skv={skv} bounded={bounded}")
    nan_pairs = ((129, 193), (193, 65), (4097, 129), (65, 4097))
    for sq, skv in nan_pairs:
        args = inputs(sq, skv, False)
        for t in args:
            t[:, 0::2] = float("nan")
        for g in check(args, slice(1, 2), f"NaN neighbours sq={sq} skv={skv}"):
            if not bool(torch.isnan(g[:, 0::2].float()).all()):
                raise AssertionError(f"K3 wrote into a NaN head's gradient at sq={sq} "
                                     f"skv={skv}")
    log(f"  K3a, K3b ({dtype}) at every Sq, Skv in {RAGGED} (B*H = 3, both K1 "
        "training forms) "
        f"and beside NaN heads: {2 * len(RAGGED) ** 2 + len(nan_pairs)} launches each "
        "within the bars; worst max_abs " + json.dumps(
            {k: float(f"{x:.3e}") for k, x in worst.items()}))
    return worst


def _time_training_attention(q, k, v, do, lse, delta, forms: bool) -> dict:
    """K1's training form, K3a and K3b timed beside their plain versions,
    SDPA's forward and its backward on the same tensors, and their bounds;
    with ``forms`` also each K1 form with the exp floor."""
    from dove_tpu_torch.ops import flash_attention as fa

    B, heads, sq, _ = q.shape
    skv = k.shape[2]
    scale = 64 ** -0.5
    sdpa = torch.nn.functional.scaled_dot_product_attention
    qq, kk, vv = (t.detach().clone().requires_grad_() for t in (q, k, v))

    def sdpa_fwd_bwd():
        sdpa(qq, kk, vv).backward(do)

    t = {}
    if forms:
        k1_forms = time_k1_forms(q, k, v)
        t.update(k1_lse_ms=k1_forms["forms_ms"]["online_lse"],
                 k1_online_ms=k1_forms["forms_ms"]["online"], k1_forms=k1_forms)
    else:
        t["k1_lse_ms"] = cuda_ms(lambda: fa.flash_attention(q, k, v, with_lse=True), 10)
    t.update(
        k3a_ms=cuda_ms(lambda: fa.flash_bwd_dq_launch(q, k, v, do, lse, delta, scale), 10),
        k3b_ms=cuda_ms(lambda: fa.flash_bwd_dkv_launch(q, k, v, do, lse, delta, scale), 10),
        k1_lse_plain_ms=cuda_ms(lambda: fa.flash_attention_plain(q, k, v, with_lse=True), 1, 0),
        k3a_plain_ms=cuda_ms(lambda: fa.flash_bwd_dq_plain(q, k, v, do, lse, delta, scale), 1, 0),
        k3b_plain_ms=cuda_ms(lambda: fa.flash_bwd_dkv_plain(q, k, v, do, lse, delta, scale), 1, 0),
        sdpa_fwd_ms=cuda_ms(lambda: sdpa(q, k, v), 10),
        sdpa_fwd_bwd_ms=cuda_ms(sdpa_fwd_bwd, 10),
    )
    t["sdpa_bwd_ms"] = t["sdpa_fwd_bwd_ms"] - t["sdpa_fwd_ms"]
    bh, mm = B * heads, 2.0 * sq * skv * 64  # FLOPs of one S x S x D product per head
    q_bytes, kv_bytes, row_bytes = sq * 64 * 2, skv * 64 * 2, sq * 4
    for name, n_mm, nbytes in (
            # q, k, v in; out and lse out
            ("k1_lse", 2, 2 * q_bytes + 2 * kv_bytes + row_bytes),
            # q, k, v, dO, lse, delta in; dq out
            ("k3a", 3, 3 * q_bytes + 2 * kv_bytes + 2 * row_bytes),
            # q, k, v, dO, lse, delta in; dk, dv out
            ("k3b", 4, 2 * q_bytes + 4 * kv_bytes + 2 * row_bytes)):
        t[f"{name}_flops"] = bh * n_mm * mm
        t[f"{name}_bound_ms"], t[f"{name}_bound_by"] = _bound(
            bh * n_mm * mm, bh * nbytes)
    t["shape"] = [B, heads, sq, 64]
    return t


def _fwd_bwd_ms(q, k, v, do) -> dict:
    """ops.attention.full_attention's forward and backward through the
    kernels ("flash": K1-lse, K3a, K3b) and through the naive path (fp32
    logits under autograd), which the automatic rule takes below 2048
    tokens."""
    from dove_tpu_torch.ops import attention as tattn

    qq, kk, vv = (t.detach().clone().requires_grad_() for t in (q, k, v))

    def run(backend):
        tattn.full_attention(qq, kk, vv, backend=backend).backward(do)

    return {f"{b}_fwd_bwd_ms": cuda_ms(lambda b=b: run(b), 10) for b in ("flash", "naive")}


def phase_k3(heads: int, seq_s2: int) -> dict:
    """K1's training form and the backward kernels against their plain
    versions, on the same bf16 inputs; the backward takes the kernel's own
    out and lse, as in training. Timed at the stage-1 shape [2, 48, 3426,
    64] and at stage 2's [1, 48, seq_s2, 64]."""
    from dove_tpu_torch.ops import flash_attention as fa

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(9)
    scale = 64 ** -0.5
    worst = {"k1_lse": 0.0, "lse": 0.0, "k3a": 0.0, "k3b": 0.0}
    timing, timing_s2 = {}, {}
    for B, sq, skv in ((TRAIN_BATCH, TRAIN_SEQ, TRAIN_SEQ), (1, 1111, 2345),
                       (1, seq_s2, seq_s2)):
        q = torch.randn((B, heads, sq, 64), generator=gen, device=dev,
                        dtype=torch.bfloat16)
        k, v = (torch.randn((B, heads, skv, 64), generator=gen, device=dev,
                            dtype=torch.bfloat16) for _ in range(2))
        do = torch.randn((B, heads, sq, 64), generator=gen, device=dev,
                         dtype=torch.bfloat16)
        out, lse = fa.flash_attention(q, k, v, with_lse=True)
        torch.cuda.synchronize()
        ref, ref_lse = fa.flash_attention_plain(q, k, v, with_lse=True)
        delta = (do.float() * out.float()).sum(-1)
        dq = fa.flash_bwd_dq_launch(q, k, v, do, lse, delta, scale)
        dk, dv = fa.flash_bwd_dkv_launch(q, k, v, do, lse, delta, scale)
        torch.cuda.synchronize()
        ref_dq = fa.flash_bwd_dq_plain(q, k, v, do, lse, delta, scale)
        ref_dk, ref_dv = fa.flash_bwd_dkv_plain(q, k, v, do, lse, delta, scale)
        lse_err = float((lse - ref_lse).abs().max())
        checks = {"k1_lse": (out, ref), "k3a dq": (dq, ref_dq),
                  "k3b dk": (dk, ref_dk), "k3b dv": (dv, ref_dv)}
        for name, (got, want) in checks.items():
            err = attn_errors(got, want)
            finite = bool(torch.isfinite(got).all())
            log(f"  {name} [{B}, {heads}, {sq}, {skv}]: max_abs_err "
                f"{err['max_abs']:.3e}, / max|ref| {err['rel_max']:.3e}, rms err / "
                f"rms ref {err['rel_rms']:.3e}, finite {finite}")
            if not finite or not within_bars(err):
                raise AssertionError(f"{name} disagrees with its plain version at "
                                     f"sq={sq} skv={skv}: {err}")
            key = name.split()[0]
            worst[key] = max(worst[key], err["max_abs"])
        log(f"  lse [{B}, {heads}, {sq}]: max_abs_err {lse_err:.3e} "
            f"(bar {K1_LSE_ABS_TOL})")
        if not lse_err <= K1_LSE_ABS_TOL:
            raise AssertionError(f"K1's logsumexp is off by {lse_err}")
        worst["lse"] = max(worst["lse"], lse_err)
        if sq == TRAIN_SEQ:
            # the bars must reject K3a skipping one 64-key tile and K3b one
            # 64-query tile
            miss_dq = attn_errors(fa.flash_bwd_dq_plain(
                q, k[:, :, 64:].contiguous(), v[:, :, 64:].contiguous(), do, lse,
                delta, scale), ref_dq)
            miss_dk, miss_dv = (attn_errors(a, b) for a, b in zip(
                fa.flash_bwd_dkv_plain(q[:, :, 64:].contiguous(), k, v,
                                       do[:, :, 64:].contiguous(),
                                       lse[:, :, 64:].contiguous(),
                                       delta[:, :, 64:].contiguous(), scale),
                (ref_dk, ref_dv)))
            log(f"  bar check: a dropped tile gives rms err / rms ref "
                f"{miss_dq['rel_rms']:.3e} (dq), {miss_dk['rel_rms']:.3e} (dk), "
                f"{miss_dv['rel_rms']:.3e} (dv)")
            if any(within_bars(m) for m in (miss_dq, miss_dk, miss_dv)):
                raise AssertionError("the K3 bars accept a dropped tile")
            timing = _time_training_attention(q, k, v, do, lse, delta, forms=True)
        elif sq == seq_s2:
            timing_s2 = _time_training_attention(q, k, v, do, lse, delta, forms=False)
            timing_s2.update(_fwd_bwd_ms(q, k, v, do))
        del q, k, v, do, out, lse, ref, ref_lse, dq, dk, dv, ref_dq, ref_dk, ref_dv
    edges = k1_edge_cases(with_lse=True)
    worst["k1_lse"] = max(worst["k1_lse"], edges["max_abs"])
    worst["lse"] = max(worst["lse"], edges["lse"])
    for key, x in k3_edge_cases().items():
        worst[key] = max(worst[key], x)
    for c in _k3_counters().values():
        c.reset()
    torch.cuda.empty_cache()
    log("phase 9 K1-lse, K3a, K3b: worst max_abs_err " + json.dumps(
        {k: float(f"{x:.3e}") for k, x in worst.items()}) + "; " + json.dumps(rounded(timing))
        + "; stage 2: " + json.dumps(rounded(timing_s2)))
    return dict(worst=worst, stage2=timing_s2, **timing)


# ---------------------------------------------------------------------------
# Phases 10 and 11: stage-1 LoRA training through DOVES1Trainer
# ---------------------------------------------------------------------------

def _train_args(out_dir: str):
    """scripts/train_s1.sh, less what this slice does not run (the dataset,
    validation): LoRA rank 128 / alpha 64 on q, k, v and out, batch 2 of
    25x320x640, bf16, gradient checkpointing, AdamW (0.9, 0.95), lr 2e-5
    constant with 100 warmup steps, max_grad_norm 0.1, t = 399, no noise."""
    from dove_tpu_torch.train.args import Args

    return Args(
        model_path="no-checkpoint", model_name="dove-s1", training_type="lora",
        rank=128, lora_alpha=64, output_dir=out_dir,
        train_resolution=(TRAIN_FRAMES, TRAIN_H, TRAIN_W), batch_size=TRAIN_BATCH,
        train_steps=TRAIN_STEPS, learning_rate=2e-5,
        lr_scheduler="constant_with_warmup", lr_warmup_steps=100, max_grad_norm=0.1,
        mixed_precision="bf16", gradient_checkpointing=True, checkpointing_steps=500,
        sr_noise_step=399, noise_step=0, num_workers=0,
    )


def train_batch(seed: int, batch: int = TRAIN_BATCH, frames: int = TRAIN_FRAMES,
                h: int = TRAIN_H, w: int = TRAIN_W) -> dict[str, torch.Tensor]:
    """Seeded smooth HQ clips [batch, frames, h, w, 3] in [-1, 1] and their
    LQ in the dataset's layout: 4x area-down, then bilinear back up to HQ
    size (dove_tpu/data/datasets.py). Made on the card."""
    import torch.nn.functional as F

    gen = torch.Generator(device="cuda").manual_seed(seed)
    coarse = torch.rand((batch, 3, 7, h // 32, w // 32), generator=gen, device="cuda")
    hq = F.interpolate(coarse, size=(frames, h, w), mode="trilinear",
                       align_corners=False) * 2 - 1
    flat = hq.permute(0, 2, 1, 3, 4).reshape(-1, 3, h, w)
    lq = F.interpolate(F.avg_pool2d(flat, 4), scale_factor=4, mode="bilinear",
                       align_corners=False)
    lq = lq.reshape(batch, frames, 3, h, w)

    def layout(x):  # -> [B, F, H, W, 3]
        return x.permute(0, 1, 3, 4, 2).contiguous()

    return {"hq_video": layout(hq.permute(0, 2, 1, 3, 4)), "lq_video": layout(lq)}


def _rel_rms(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.float() - b.float()).square().mean().sqrt()
                 / b.float().square().mean().sqrt())


def phase_train_kernel_vs_plain() -> None:
    import dataclasses

    from dove_tpu_torch import cogvideox1_5_5b
    from dove_tpu_torch.train.trainer import DOVES1Trainer

    base = cogvideox1_5_5b()
    cfg = dataclasses.replace(base, dit=dataclasses.replace(base.dit, num_layers=2))
    tr = DOVES1Trainer(_train_args("build/chip_smoke_train"), pipeline_config=cfg,
                       device="cuda")
    tr.load_components()
    with torch.no_grad():  # B off zero, so that the A gradients are not 0
        gen = torch.Generator(device="cuda").manual_seed(10)
        for ab in tr.lora_params.values():
            ab["B"].copy_(torch.randn(ab["B"].shape, generator=gen, device="cuda") * 1e-2)
    batch = tr.device_batch(train_batch(seed=10))
    runs = {}
    for backend in (None, "plain"):
        tr.attention_backend = backend
        for c in _k3_counters().values():
            c.reset()
        loss, _, grads = tr.loss_and_grads(batch)
        runs[backend] = (float(loss), grads,
                         {n: c.count for n, c in _k3_counters().items()})
    (k_loss, k_grads, k_counts), (p_loss, p_grads, p_counts) = runs[None], runs["plain"]
    want = {"k1": 0, "k1_lse": 2 * cfg.dit.num_layers, "k2": 0,
            "k3a": cfg.dit.num_layers, "k3b": cfg.dit.num_layers}
    if k_counts != want or any(p_counts.values()):
        raise AssertionError(f"phase 10 launches: kernel run {k_counts} (want {want}), "
                             f"plain run {p_counts}")
    rel = {f"{t}.{ab}": _rel_rms(g, h) for (t, ab), g, h in zip(
        [(t, ab) for t in tr.lora_params for ab in ("A", "B")], k_grads, p_grads)}
    loss_rel = abs(k_loss - p_loss) / abs(p_loss)
    log(f"phase 10 training step kernel vs plain (2 layers, full width, batch "
        f"{TRAIN_BATCH}x{TRAIN_FRAMES}x{TRAIN_H}x{TRAIN_W}): loss {k_loss:.6f} vs "
        f"{p_loss:.6f} (rel {loss_rel:.2e}, bar {TRAIN_LOSS_REL_TOL}), LoRA grad "
        f"rms err / rms ref {json.dumps({k: float(f'{x:.2e}') for k, x in rel.items()})} "
        f"(bar {TRAIN_GRAD_REL_RMS_TOL}), launches {k_counts}")
    if not loss_rel <= TRAIN_LOSS_REL_TOL or not all(
            x <= TRAIN_GRAD_REL_RMS_TOL for x in rel.values()):
        raise AssertionError("phase 10: the kernels' training step disagrees with the "
                             "plain one")
    if not all(float(g.abs().max()) > 0 for g in k_grads):
        raise AssertionError("phase 10: a LoRA gradient is zero")
    del tr, batch, runs, k_grads, p_grads
    torch.cuda.empty_cache()


def lora_round_trip(tr, out_dir: str) -> str:
    """The trainer's LoRA export (export_lora_safetensors) read back through
    the port's own safetensors reader, equal bit for bit to the trained
    tensors, then fused into the trainer's DiT (which it changes in place):
    every adapted weight must equal the LoRA merge (train/lora.py
    merged_weight) to within the rounding of the fused delta. Returns a log
    fragment."""
    from pathlib import Path

    from dove_tpu_torch import safetensors_io, weights
    from dove_tpu_torch.train import checkpointing as ckpt_mod
    from dove_tpu_torch.train import lora as lora_mod

    path = Path(out_dir) / "export" / "pytorch_lora_weights.safetensors"
    t0 = time.perf_counter()
    tr.export(path.parent)
    read = safetensors_io.load_file(path)
    load_s = time.perf_counter() - t0
    want = ckpt_mod.lora_state_dict(tr.lora_params)
    if sorted(read) != sorted(want) or not all(
            torch.equal(read[k], torch.from_numpy(v)) for k, v in want.items()):
        raise AssertionError("the LoRA read back differs from the exported one")
    layers = len(tr.dit.transformer_blocks)
    targets = {"to_q": "to_q", "to_k": "to_k", "to_v": "to_v", "to_out": "to_out.0"}
    with torch.no_grad():
        before = {(i, t): tr.dit.transformer_blocks[i].attn1.get_submodule(name)
                  .weight.detach().clone()
                  for i in (0, layers - 1) for t, name in targets.items()}
        merged = {(i, t): lora_mod.merged_weight(
            w, tr.lora_params[t]["A"][i], tr.lora_params[t]["B"][i], tr.lora_scale)
            for (i, t), w in before.items()}
    weights.fuse_lora_into_dit(tr.dit, {k: v.cuda() for k, v in read.items()},
                               scale=tr.lora_scale)
    worst = 0.0
    for (i, t), m in merged.items():
        w = tr.dit.transformer_blocks[i].attn1.get_submodule(targets[t]).weight
        # the fused weight rounds the delta to bf16, then the sum; the merge
        # rounds the sum alone: apart by an ulp of the larger of the weight
        # and the merge (where the two nearly cancel, of the weight)
        scale = torch.maximum(before[i, t].float().abs(), m.float().abs())
        ulp = torch.ldexp(torch.ones_like(scale), torch.frexp(scale)[1] - 8)
        worst = max(worst, float(((w.float() - m.float()).abs() / ulp).max()))
    if not worst <= 2.0:
        raise AssertionError(f"the fused LoRA is {worst} bf16 ulps from the merge")
    return (f"LoRA export {path.stat().st_size / 2**20:.0f} MiB written and read back "
            f"through dove_tpu_torch.safetensors_io in {load_s:.1f}s, {len(read)} "
            f"tensors equal; fused into {layers} layers, within {worst:.0f} bf16 ulp "
            "of the merge")


def phase_train_recipe(profile_dir: str | None = None) -> dict:
    import shutil

    from dove_tpu_torch.train import lora as lora_mod
    from dove_tpu_torch.train.trainer import DOVES1Trainer

    out_dir = "build/chip_smoke_train"
    shutil.rmtree(out_dir, ignore_errors=True)
    resident = torch.cuda.memory_allocated()  # what earlier phases left: ~0
    t0 = time.perf_counter()
    tr = DOVES1Trainer(_train_args(out_dir), device="cuda")
    tr.load_components()
    tr.prepare_optimizer(TRAIN_STEPS)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    layers = tr.config.dit.num_layers
    n_lora = lora_mod.lora_param_count(tr.lora_params)
    batch = tr.device_batch(train_batch(seed=11))
    counters = _k3_counters()
    want = {"k1": 0, "k1_lse": 2 * layers, "k2": 0, "k3a": layers, "k3b": layers}

    torch.cuda.reset_peak_memory_stats()
    for c in counters.values():
        c.reset()
    steps = []
    for _ in range(TRAIN_STEPS):
        before = {n: c.count for n, c in counters.items()}
        t0 = time.perf_counter()
        loss, aux, gnorm = tr.train_step(batch)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        tr.global_step += 1
        per_step = {n: c.count - before[n] for n, c in counters.items()}
        steps.append(dict(wall_s=wall, loss=float(loss), grad_norm=float(gnorm),
                          split_s=dict(tr.step_times), launches=per_step))
        log(f"  step {tr.global_step}: loss {float(loss):.6f}, grad_norm "
            f"{float(gnorm):.4e}, wall {wall:.3f}s, split "
            f"{json.dumps({k: round(v, 3) for k, v in tr.step_times.items()})}, "
            f"launches {per_step}")
        if per_step != want:
            raise AssertionError(f"launches per step {per_step}, want {want}")
        if not math.isfinite(float(loss)) or not float(gnorm) > 0:
            raise AssertionError(f"step {tr.global_step}: loss {float(loss)}, "
                                 f"grad_norm {float(gnorm)}")
    launches = {n: c.count for n, c in counters.items()}
    peak = torch.cuda.max_memory_allocated()
    b_max = max(float(ab["B"].detach().abs().max()) for ab in tr.lora_params.values())
    if not b_max > 0:
        raise AssertionError("LoRA B did not move off zero")
    # the encode's share of the peak: the two clips' encode alone, beside
    # the resident weights and LoRA state
    torch.cuda.reset_peak_memory_stats()
    tr._encode(batch["lq_video"], None)
    enc_peak = torch.cuda.max_memory_allocated()
    if profile_dir is not None:
        def run() -> dict:
            tr.train_step(batch)
            tr.global_step += 1
            return tr.step_times

        profile_run(run, profile_dir, "train_step", "phase 11")

    # a checkpoint saved and resumed on the card
    saved = [t.detach().clone() for t in tr.trainable_tensors()]
    t0 = time.perf_counter()
    path = tr.save(tr.global_step)
    save_s = time.perf_counter() - t0
    ckpt_bytes = sum(f.stat().st_size for f in path.iterdir())
    with torch.no_grad():
        for t in tr.trainable_tensors() + tr.optimizer.mu + tr.optimizer.nu:
            t.zero_()
    step = tr.global_step
    tr.global_step, tr.optimizer.count = 0, 0
    t0 = time.perf_counter()
    tr.maybe_resume()
    resume_s = time.perf_counter() - t0
    if tr.global_step != step or tr.optimizer.count != step or not all(
            torch.equal(a, b) for a, b in zip(tr.trainable_tensors(), saved)):
        raise AssertionError("the resumed state differs from the saved one")
    lora_check = lora_round_trip(tr, out_dir)
    shutil.rmtree(out_dir, ignore_errors=True)

    median = statistics.median(s["wall_s"] for s in steps[1:])
    mid = min(steps[1:], key=lambda s: abs(s["wall_s"] - median))
    log(f"phase 11 stage-1 recipe (5B, {layers} layers, LoRA rank 128 on q/k/v/out: "
        f"{n_lora / 1e6:.1f}M fp32 parameters; batch {TRAIN_BATCH}x{TRAIN_FRAMES}x"
        f"{TRAIN_H}x{TRAIN_W}, attention [{TRAIN_BATCH}, 48, {TRAIN_SEQ}, 64]): "
        f"{TRAIN_STEPS} steps, step wall median of steps 2-{TRAIN_STEPS} "
        f"{median:.3f}s, split {json.dumps({k: round(v, 3) for k, v in mid['split_s'].items()})}, "
        f"first step {steps[0]['wall_s']:.3f}s, peak {peak / 2**30:.2f} GiB (the LQ "
        f"batch's encode alone {enc_peak / 2**30:.2f} GiB; {resident / 2**30:.2f} GiB "
        f"held before the phase), launches "
        f"{launches}, max|B| {b_max:.3e}; checkpoint {ckpt_bytes / 2**30:.2f} GiB saved "
        f"in {save_s:.1f}s, resumed in {resume_s:.1f}s; weights init {init_s:.1f}s; "
        f"{lora_check}")
    del tr, saved, batch
    torch.cuda.empty_cache()
    return dict(launches=launches, steps=steps, step_median_s=median,
                peak_bytes=peak)


# ---------------------------------------------------------------------------
# Phases 16 and 17: stage-2 SFT through DOVES2Trainer
# ---------------------------------------------------------------------------

def _s2_args(out_dir: str, seed: int):
    """scripts/train_s2.sh, less what this slice does not run (the image and
    video datasets, the stage-1 export it starts from): SFT of the whole DiT,
    batch 1 of 2x320x640, bf16, gradient checkpointing, AdamW (0.9, 0.95),
    lr 5e-6 constant with 10 warmup steps, max_grad_norm 0.1, t = 399, no
    noise, image_ratio 0.8, DISTS weight 1.0 on a seeded VGG16 (no DISTS
    weights are in the repo: allow_random_perceptual), frame difference 1.0."""
    from dove_tpu_torch.train.args import Args

    return Args(
        model_path="no-checkpoint", model_name="dove-s2", training_type="sft",
        output_dir=out_dir, train_resolution=(S2_FRAMES, S2_H, S2_W), batch_size=1,
        train_steps=S2_STEPS, learning_rate=5e-6, lr_scheduler="constant_with_warmup",
        lr_warmup_steps=10, max_grad_norm=0.1, mixed_precision="bf16",
        gradient_checkpointing=True, checkpointing_steps=100, sr_noise_step=399,
        noise_step=0, image_ratio=0.8, use_perceptual_loss=True, dists_weight=1.0,
        frame_diff_weight=1.0, allow_random_perceptual=True, num_workers=0, seed=seed,
    )


def s2_pairs(seed: int) -> tuple[dict, dict]:
    """A clip pair and an image pair, seeded, on the card: the video step's
    and the image step's batch as DOVES2Trainer.train_step hands them on."""
    clip = train_batch(seed, 1, S2_FRAMES, S2_H, S2_W)
    image = train_batch(seed + 1, 1, 1, S2_H, S2_W)
    return clip, image


def _s2_trainer(cfg, seed: int):
    import os

    from dove_tpu_torch.models import vae as vae_mod
    from dove_tpu_torch.train.trainer import DOVES2Trainer

    # the seeded VGG16 of the recipe's opt-in, whatever this shell exports
    os.environ.pop("DOVE_DISTS_WEIGHTS", None)
    vae_mod.set_pallas_conv(False)  # K5 has no backward
    tr = DOVES2Trainer(_s2_args("build/chip_smoke_s2", seed), pipeline_config=cfg,
                       device="cuda")
    tr.load_components()
    return tr


def _remat_decode_check(cfg, vae) -> dict:
    """The decode with gradients at the stage-2 shape (two 1-frame latents
    of 40x80) with and without checkpointing per level: pixels, the gradient
    with respect to the latent, and the peak memory of each."""
    from dove_tpu_torch.models import vae as vae_mod

    gen = torch.Generator(device="cuda").manual_seed(16)
    z = torch.randn((S2_FRAMES, 1, S2_H // 8, S2_W // 8, cfg.vae.latent_channels),
                    generator=gen, device="cuda", dtype=torch.bfloat16)
    cot = torch.randn((S2_FRAMES, 1, S2_H, S2_W, 3), generator=gen, device="cuda",
                      dtype=torch.bfloat16)
    runs = {}
    for remat in (False, True):
        zz = z.clone().requires_grad_()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        px = vae_mod.decode(cfg.vae, vae, zz, remat=remat)
        (g,) = torch.autograd.grad(px, zz, cot)
        torch.cuda.synchronize()
        runs[remat] = (px.detach(), g, time.perf_counter() - t0,
                       torch.cuda.max_memory_allocated() - base)
    (p0, g0, t_off, m_off), (p1, g1, t_on, m_on) = runs[False], runs[True]
    out = dict(px_rel_rms=_rel_rms(p1, p0), grad_rel_rms=_rel_rms(g1, g0),
               px_equal=bool(torch.equal(p1, p0)), grad_equal=bool(torch.equal(g1, g0)),
               wall_s={"off": t_off, "on": t_on},
               peak_gib={"off": m_off / 2**30, "on": m_on / 2**30})
    if not (out["px_rel_rms"] <= REMAT_REL_RMS_TOL and out["grad_rel_rms"] <= REMAT_REL_RMS_TOL
            and bool(torch.isfinite(g1).all())):
        raise AssertionError(f"phase 16: the decode with remat differs: {out}")
    return out


def _dit_part(tr, batch, cot):
    """The DiT's part of a stage-2 step alone: x0 from the batch's per-frame
    encode (the posterior mean) and every DiT parameter's gradient for the
    cotangent ``cot`` on x0 (zeros where a parameter gets none)."""
    from dove_tpu_torch.train import losses

    lq = tr._encode(batch["lq_video"], None, per_frame=True).to(tr.dtype)
    params = list(tr.dit.parameters())
    x0 = losses.one_step_x0_latent(tr.config, tr.schedule, tr.dit, lq,
                                   batch["prompt_embeds"], None, **tr.dit_kwargs())
    grads = torch.autograd.grad(x0, params, cot.to(x0.dtype), allow_unused=True)
    return x0.detach(), [torch.zeros_like(p) if g is None else g
                         for p, g in zip(params, grads)]


def _worst_rel(names, grads, refs) -> tuple[dict, list]:
    """Each nonzero reference gradient's rms err / rms ref, and the names of
    those that are zero in the reference (and must be in ``grads`` too)."""
    rel, zero = {}, []
    for n, g, h in zip(names, grads, refs):
        if float(h.float().abs().max()) == 0.0:
            zero.append(n)
            if float(g.float().abs().max()) != 0.0:
                raise AssertionError(f"{n} has a gradient in one run only")
        else:
            rel[n] = _rel_rms(g, h)
    return rel, zero


def phase_s2_kernel_vs_plain() -> None:
    """One stage-2 SFT step at full width and 2 DiT layers, as a video step
    and as an image step, through the kernels, the plain attention and the
    naive one. The loss terms of the whole step are compared at phase 10's
    bar. The DiT gradients are compared on the DiT's own part of the step
    (x0 and the gradients for one seeded cotangent on it), at phase 10's
    bar: the loss's gradient with respect to x0 is not continuous in x0
    (the frame difference's L1 sign, the clamp, VGG's relus, all on bf16
    pixels), so a one-ulp change of a pixel moves it, and the whole step's
    DiT gradients of the kernel run and of the naive one are both shown
    beside the plain run's. Then the decode with and without remat."""
    import dataclasses

    from dove_tpu_torch import cogvideox1_5_5b

    base = cogvideox1_5_5b()
    cfg = dataclasses.replace(base, dit=dataclasses.replace(base.dit, num_layers=2))
    tr = _s2_trainer(cfg, seed=0)
    clip, image = s2_pairs(seed=16)
    layers = cfg.dit.num_layers
    want = {"k1": 0, "k1_lse": 2 * layers, "k2": 0, "k3a": layers, "k3b": layers}
    none = dict.fromkeys(want, 0)
    names = [n for n, _ in tr.dit.named_parameters()]
    gen = torch.Generator(device="cuda").manual_seed(161)
    for kind, pair in (("video", clip), ("image", image)):
        batch = tr.device_batch(pair)
        runs = {}
        # the trainer's own attention on the card; the reference; a second one
        for backend in ("flash", "plain", "naive"):
            tr.attention_backend = backend
            for c in _k3_counters().values():
                c.reset()
            loss, aux, grads = tr.loss_and_grads(batch)
            counts = {n: c.count for n, c in _k3_counters().items()}
            if counts != (want if backend == "flash" else none):
                raise AssertionError(f"phase 16 {kind} {backend} launches {counts}")
            runs[backend] = ({k: float(v) for k, v in aux.items()}, grads)
        terms = {"loss", "loss_pixel", "loss_perceptual"} | (
            {"loss_frame_diff"} if kind == "video" else set())
        (k_aux, k_grads), (p_aux, p_grads), (_, n_grads) = (
            runs["flash"], runs["plain"], runs["naive"])
        if set(k_aux) != terms or set(p_aux) != terms:
            raise AssertionError(f"phase 16 {kind} loss terms {sorted(k_aux)}")
        loss_rel = {k: abs(k_aux[k] - p_aux[k]) / abs(p_aux[k]) for k in terms}
        step_k, _ = _worst_rel(names, k_grads, p_grads)
        step_n, _ = _worst_rel(names, n_grads, p_grads)
        del runs, k_grads, p_grads, n_grads
        # the DiT's part of the step, one cotangent for both runs
        lat = pair["lq_video"].shape[1]
        cot = torch.randn((1, lat, S2_H // 8, S2_W // 8, cfg.vae.latent_channels),
                          generator=gen, device="cuda")
        parts = {}
        for backend in ("flash", "plain"):
            tr.attention_backend = backend
            parts[backend] = _dit_part(tr, batch, cot)
        (k_x0, k_g), (p_x0, p_g) = parts["flash"], parts["plain"]
        x0_rel = _rel_rms(k_x0, p_x0)
        rel, zero = _worst_rel(names, k_g, p_g)
        worst = max(rel, key=rel.get)
        log(f"  {kind} step (S = {stage2_seq_len(cfg)}): loss {k_aux['loss']:.6f} vs "
            f"{p_aux['loss']:.6f}, term rel "
            f"{json.dumps({k: float(f'{x:.2e}') for k, x in loss_rel.items()})} (bar "
            f"{TRAIN_LOSS_REL_TOL}); the DiT's part: x0 rms err / rms ref {x0_rel:.2e}, "
            f"worst DiT grad {rel[worst]:.2e} ({worst}; {len(rel)} tensors, {len(zero)} "
            f"zero in both; bar {TRAIN_GRAD_REL_RMS_TOL}); the whole step's DiT grads "
            f"against the plain run's, worst / median: kernels "
            f"{max(step_k.values()):.2e} / {statistics.median(step_k.values()):.2e}, "
            f"naive attention {max(step_n.values()):.2e} / "
            f"{statistics.median(step_n.values()):.2e}")
        if not all(x <= TRAIN_LOSS_REL_TOL for x in loss_rel.values()) or not (
                x0_rel <= TRAIN_LOSS_REL_TOL) or not all(
                x <= TRAIN_GRAD_REL_RMS_TOL for x in rel.values()):
            raise AssertionError(f"phase 16: the kernels' {kind} step disagrees with "
                                 "the plain one")
        if len(rel) < len(names) // 2:
            raise AssertionError(f"phase 16 {kind}: {len(zero)} of {len(names)} DiT "
                                 "gradients are zero")
        del parts, k_g, p_g, batch
    tr.attention_backend = "flash"
    remat = _remat_decode_check(cfg, tr.vae)
    log(f"phase 16 stage-2 step kernel vs plain (SFT, 2 layers, full width, clip "
        f"1x{S2_FRAMES}x{S2_H}x{S2_W} and image 1x1x{S2_H}x{S2_W}): video and image "
        f"steps within the bars; decode remat on vs off at [{S2_FRAMES}, 1, "
        f"{S2_H // 8}, {S2_W // 8}, 16]: pixels rms err / rms {remat['px_rel_rms']:.2e}, "
        f"grad {remat['grad_rel_rms']:.2e} (bar {REMAT_REL_RMS_TOL}; equal bit for bit: "
        f"pixels {remat['px_equal']}, grad {remat['grad_equal']}), wall "
        f"{json.dumps(rounded(remat['wall_s'], 3))} s, peak above the weights "
        f"{json.dumps(rounded(remat['peak_gib'], 3))} GiB")
    del tr
    torch.cuda.empty_cache()


def phase_s2_recipe(profile_dir: str | None = None) -> dict:
    """scripts/train_s2.sh's SFT step at 42 layers: S2_STEPS steps through
    DOVES2Trainer.train_step from a seed whose steps take both the image
    pair and the clip, with launches, the split and the loss terms per
    step, and the peak memory."""
    from dove_tpu_torch import cogvideox1_5_5b
    from dove_tpu_torch.train.trainer import DOVES2Trainer

    def coins(seed: int) -> list[bool]:  # a trainer's coin needs no components
        tr = DOVES2Trainer(_s2_args("build/chip_smoke_s2", seed), device="cuda")
        return [tr.image_step(s) for s in range(S2_STEPS)]

    seed = next(s for s in range(1000) if len(set(coins(s))) == 2)
    resident = torch.cuda.memory_allocated()  # what earlier phases left: ~0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    tr = _s2_trainer(cogvideox1_5_5b(), seed)
    tr.prepare_optimizer(S2_STEPS)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    held = torch.cuda.memory_allocated()
    layers = tr.config.dit.num_layers
    n_params = sum(p.numel() for p in tr.trainable_tensors())
    kinds = ["image" if tr.image_step(s) else "video" for s in range(S2_STEPS)]
    clip, image = s2_pairs(seed=17)
    batch = tr.device_batch({**clip, "hq_image": image["hq_video"],
                             "lq_image": image["lq_video"]})
    counters = _k3_counters()
    want = {"k1": 0, "k1_lse": 2 * layers, "k2": 0, "k3a": layers, "k3b": layers}
    watch = tr.dit.proj_out.weight.detach().clone()
    for c in counters.values():
        c.reset()
    steps = []
    for kind in kinds:
        before = {n: c.count for n, c in counters.items()}
        t0 = time.perf_counter()
        loss, aux, gnorm = tr.train_step(batch)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        tr.global_step += 1
        per_step = {n: c.count - before[n] for n, c in counters.items()}
        terms = {k: float(v) for k, v in aux.items()}
        steps.append(dict(kind=kind, wall_s=wall, loss=float(loss), terms=terms,
                          grad_norm=float(gnorm), split_s=dict(tr.step_times),
                          launches=per_step))
        log(f"  step {tr.global_step} ({kind}): loss terms "
            f"{json.dumps({k: round(v, 6) for k, v in terms.items()})}, grad_norm "
            f"{float(gnorm):.4e}, wall {wall:.3f}s, split "
            f"{json.dumps({k: round(v, 3) for k, v in tr.step_times.items()})}, "
            f"launches {per_step}")
        if per_step != want:
            raise AssertionError(f"launches per step {per_step}, want {want}")
        if ("loss_frame_diff" in terms) != (kind == "video"):
            raise AssertionError(f"step {tr.global_step} ({kind}): terms {sorted(terms)}")
        if not all(math.isfinite(v) for v in terms.values()) or not float(gnorm) > 0:
            raise AssertionError(f"step {tr.global_step}: terms {terms}, grad_norm "
                                 f"{float(gnorm)}")
    peak = torch.cuda.max_memory_allocated()
    launches = {n: c.count for n, c in counters.items()}
    moved = float((tr.dit.proj_out.weight.detach().float() - watch.float()).abs().max())
    if not moved > 0:
        raise AssertionError("the DiT did not move")
    if profile_dir is not None:
        def run() -> dict:
            tr.train_step(batch)
            tr.global_step += 1
            return tr.step_times

        profile_run(run, profile_dir, "s2_train_step", "phase 17")
    walls = [s["wall_s"] for s in steps[1:]]
    median = statistics.median(walls)
    by_kind = {k: [round(s["wall_s"], 3) for s in steps if s["kind"] == k]
               for k in ("image", "video")}
    log(f"phase 17 stage-2 recipe (5B SFT, {layers} layers, {n_params / 1e9:.3f}B bf16 "
        f"parameters with bf16 gradients and AdamW moments; seed {seed}: steps "
        f"{kinds}; attention [1, {tr.config.dit.num_attention_heads}, "
        f"{stage2_seq_len(tr.config)}, 64]): step wall "
        f"median of steps 2-{S2_STEPS} {median:.3f}s, by kind {json.dumps(by_kind)}, "
        f"first step {steps[0]['wall_s']:.3f}s; peak {peak / 2**30:.2f} GiB of "
        f"{torch.cuda.get_device_properties(0).total_memory / 2**30:.1f} "
        f"(weights and optimizer state {held / 2**30:.2f} GiB before the first step; "
        f"{resident / 2**30:.2f} GiB held before the phase), launches {launches}, "
        f"max |d proj_out| {moved:.3e}; init {init_s:.1f}s")
    del tr, batch, watch
    torch.cuda.empty_cache()
    return dict(launches=launches, steps=steps, step_median_s=median, peak_bytes=peak,
                held_bytes=held, seed=seed, kinds=kinds, n_params=n_params)


# ---------------------------------------------------------------------------
# Phase 12: K4 and K5 against their plain versions
# ---------------------------------------------------------------------------

def _conv_inputs(shape, gen, int8: bool):
    """Seeded operands in the kernel's layouts: x [B, Fo + kt - 1, Ho + 2,
    Wo + 2, Cin], packed w [kt * 9, Cout, Cin], and for K4 the fp32 scale."""
    B, Fo, Ho, Wo, cin, cout, kt = shape
    dev = torch.device("cuda")
    shape_x, shape_w = (B, Fo + kt - 1, Ho + 2, Wo + 2, cin), (kt * 9, cout, cin)
    if int8:
        x = torch.randint(-127, 128, shape_x, generator=gen, device=dev,
                          dtype=torch.int8)
        w = torch.randint(-127, 128, shape_w, generator=gen, device=dev,
                          dtype=torch.int8)
        return x, w, torch.rand(cout, generator=gen, device=dev) * 1e-4 + 1e-6
    x = torch.randn(shape_x, generator=gen, device=dev, dtype=torch.bfloat16)
    w = (torch.randn(shape_w, generator=gen, device=dev) * (kt * 9 * cin) ** -0.5)
    return x, w.to(torch.bfloat16), None


def _bf16_ulp(ref: torch.Tensor) -> torch.Tensor:
    _, exponent = torch.frexp(ref.float().abs())
    return torch.ldexp(torch.ones_like(ref, dtype=torch.float32), exponent - 8)


def _conv_bound(shape, in_bytes: int, out_bytes: int, peak_ops: float):
    B, Fo, Ho, Wo, cin, cout, kt = shape
    ops = 2.0 * kt * 9 * cin * cout * B * Fo * Ho * Wo
    nbytes = (B * (Fo + kt - 1) * (Ho + 2) * (Wo + 2) * cin * in_bytes
              + kt * 9 * cin * cout * in_bytes + B * Fo * Ho * Wo * cout * out_bytes)
    ops_s, bytes_s = ops / peak_ops, nbytes / PEAK_BYTES
    return (max(ops_s, bytes_s) * 1e3, "operations" if ops_s >= bytes_s else "bytes",
            ops)


# K4 and K5 tile 384 flat positions (q = f * Hp * Wp + h * Wp + w) in
# 64-row blocks: heights and widths around the blocks and the tile, every
# pair of them in one frame of one window, then the other axes of the
# kernel's shapes.
CONV_RAGGED_HW = (1, 63, 64, 65, 127, 128, 129, 383, 384, 385)
CONV_RAGGED = tuple((1, 1, h, w, 64, 128, 3) for h in CONV_RAGGED_HW
                    for w in CONV_RAGGED_HW) + (
    (2, 2, 65, 129, 128, 256, 3),  # two windows, two cout blocks
    (2, 1, 63, 385, 256, 128, 1),  # per frame, two windows
    (1, 3, 127, 64, 512, 128, 3),  # the widest Cin
    (2, 1, 1, 383, 64, 256, 1),
    (1, 2, 384, 1, 128, 128, 3),
)


def _k5_bar(ref: torch.Tensor, kt: int, cin: int) -> float:
    return (K5_REL_TOL * max(1.0, (kt * 9 * cin / K5_TOL_TERMS) ** 0.5)
            * float(ref.abs().max()))


def conv_ragged_sweep(gen) -> dict:
    """K4 bit for bit in its three output forms and K5 within its bars at
    every CONV_RAGGED shape; a plain version without one tap is rejected by
    both at the first shape of each k_t."""
    from dove_tpu_torch.ops import conv3d_int8 as conv

    worst_k5, seen_kt = 0.0, set()
    for shape in CONV_RAGGED:
        B, Fo, Ho, Wo, cin, cout, kt = shape
        x, w, scale = _conv_inputs(shape, gen, int8=True)
        addend = torch.randn((cout, min(Ho, 3), min(Wo, 3)), generator=gen, device="cuda")
        bias = torch.randn(cout, generator=gen, device="cuda")
        out = conv.conv_taps(x, w, scale * 1e3, kt, torch.bfloat16, True, addend=addend,
                             bias=bias)
        out_f32 = conv.conv_taps(x, w, scale, kt, torch.float32, channels_first=True)
        out_bf = conv.conv_taps(x, w, scale, kt, torch.bfloat16)
        torch.cuda.synchronize()
        ref = conv.conv_taps_plain(x, w, scale * 1e3, kt, torch.bfloat16, True,
                                   addend=addend, bias=bias)
        ref_f32 = conv.conv_taps_plain(x, w, scale, kt, torch.float32, channels_first=True)
        if not (torch.equal(out, ref) and torch.equal(out_f32, ref_f32) and torch.equal(
                out_bf.permute(0, 4, 1, 2, 3), ref_f32.to(torch.bfloat16))):
            raise AssertionError(f"K4 differs from its plain version at ragged {shape}")
        if kt not in seen_kt:
            short = conv.conv_taps_plain(x, w, scale, kt, torch.float32, True,
                                         skip_tap=kt * 9 - 1)
            if torch.equal(short, ref_f32):
                raise AssertionError("K4's bar accepts a plain version without one tap")
        x, w, _ = _conv_inputs(shape, gen, int8=False)
        out = conv.conv_taps(x, w, None, kt, torch.float32, channels_first=True)
        out_bf = conv.conv_taps(x, w, None, kt, torch.bfloat16)
        torch.cuda.synchronize()
        ref = conv.conv_taps_plain(x, w, None, kt, torch.float32, channels_first=True)
        bar = _k5_bar(ref, kt, cin)
        err = float((out - ref).abs().max())
        ref_bf = ref.permute(0, 2, 3, 4, 1).to(torch.bfloat16)
        over = float(((out_bf.float() - ref_bf.float()).abs() - _bf16_ulp(ref_bf)
                      - bar).max())
        if not (err <= bar and over <= 0):
            raise AssertionError(f"K5 differs from its plain version at ragged {shape}: "
                                 f"max |diff| {err} (bar {bar}), bf16 over one ulp by {over}")
        if kt not in seen_kt:
            short = conv.conv_taps_plain(x, w, None, kt, torch.float32, True,
                                         skip_tap=kt * 9 - 1)
            if float((short - ref).abs().max()) <= bar:
                raise AssertionError("K5's bar accepts a plain version without one tap")
            seen_kt.add(kt)
        worst_k5 = max(worst_k5, err / float(ref.abs().max()))
        del x, w, out, out_bf, ref, ref_bf
    torch.cuda.empty_cache()
    return dict(cases=len(CONV_RAGGED), k5_worst_rel_err=worst_k5)


def conv_nan_neighbours(gen) -> dict:
    """K5 with NaN in its input: all of one window, or the last frame of the
    other. Tiles run across frames and windows, computing positions they
    never store; an output whose taps read no NaN must stay its plain
    version's. Returns the outputs checked."""
    from dove_tpu_torch.ops import conv3d_int8 as conv

    checked = 0
    for shape in ((2, 3, 37, 53, 128, 128, 3), (2, 3, 37, 53, 128, 128, 1)):
        B, Fo, Ho, Wo, cin, cout, kt = shape
        x, w, _ = _conv_inputs(shape, gen, int8=False)
        for b_nan, frames in ((0, slice(None)), (1, slice(-1, None))):
            xn = x.clone()
            xn[b_nan, frames] = float("nan")
            out = conv.conv_taps(xn, w, None, kt, torch.float32, channels_first=True)
            torch.cuda.synchronize()
            ref = conv.conv_taps_plain(xn, w, None, kt, torch.float32, channels_first=True)
            clean = torch.isfinite(ref)  # the outputs whose taps read no NaN
            want = Fo * Ho * Wo * cout * (B - 1) + (
                0 if frames == slice(None) else (Fo - 1) * Ho * Wo * cout)
            if int(clean.sum()) != want:
                raise AssertionError(f"NaN neighbour case {shape}: {int(clean.sum())} "
                                     f"clean outputs, want {want}")
            bar = _k5_bar(ref[clean], kt, cin)
            err = float((out[clean] - ref[clean]).abs().max())
            if not (bool(torch.isfinite(out[clean]).all()) and err <= bar):
                raise AssertionError(f"K5 beside NaN inputs at {shape} (window {b_nan}): "
                                     f"max |diff| {err} on clean outputs (bar {bar})")
            checked += int(clean.sum())
    return dict(clean_outputs_checked=checked)


def phase_conv_kernels() -> tuple[dict, dict, dict]:
    """K4 and K5 alone, then the quantizer's pass. K4 is exact (int32 sums, one fp32 multiply, one
    rounding), so it must equal its plain version; K5 sums fp32 products in
    another order than its plain version."""
    import torch.nn.functional as F

    from dove_tpu_torch.ops import conv3d_int8 as conv

    gen = torch.Generator(device="cuda").manual_seed(12)
    rows = {"k4": [], "k5": []}
    worst_k5 = 0.0
    for shape in CONV_SHAPES:
        B, Fo, Ho, Wo, cin, cout, kt = shape
        main = shape == CONV_SHAPES[0]
        # K4: bf16 NCDHW out with the offset term and the bias in the epilogue
        # is what the VAE asks for; bf16 NDHWC and fp32 out with the scale
        # alone are the TPU kernel's forms
        x, w, scale = _conv_inputs(shape, gen, int8=True)
        addend = torch.randn((cout, min(Ho, 3), min(Wo, 3)), generator=gen, device="cuda")
        bias = torch.randn(cout, generator=gen, device="cuda")
        vae_form = dict(addend=addend, bias=bias)
        scale_big = scale * 1e3  # outputs of the order of addend and bias
        out = conv.conv_taps(x, w, scale_big, kt, torch.bfloat16, channels_first=True,
                             **vae_form)
        out_f32 = conv.conv_taps(x, w, scale, kt, torch.float32, channels_first=True)
        out_bf = conv.conv_taps(x, w, scale, kt, torch.bfloat16)
        torch.cuda.synchronize()
        ref = conv.conv_taps_plain(x, w, scale_big, kt, torch.bfloat16,
                                   channels_first=True, **vae_form)
        ref_f32 = conv.conv_taps_plain(x, w, scale, kt, torch.float32, channels_first=True)
        equal = bool(torch.equal(out, ref))
        equal_f32 = bool(torch.equal(out_f32, ref_f32))
        equal_bf = bool(torch.equal(out_bf.permute(0, 4, 1, 2, 3),
                                    ref_f32.to(torch.bfloat16)))
        max_err = max(float((out.float() - ref.float()).abs().max()),
                      float((out_f32 - ref_f32).abs().max()))
        if not (equal and equal_f32 and equal_bf and bool(torch.isfinite(out).all())):
            raise AssertionError(
                f"K4 differs from its plain version at {shape}: max |diff| {max_err}; "
                f"equal: VAE form {equal}, fp32 out {equal_f32}, bf16 NDHWC out {equal_bf}")
        t4 = dict(shape=list(shape), max_abs_err=max_err)
        if main or kt == 1:
            short = conv.conv_taps_plain(x, w, scale_big, kt, torch.bfloat16,
                                         channels_first=True, skip_tap=kt * 9 // 2,
                                         **vae_form)
            if torch.equal(short, ref):
                raise AssertionError("K4's bar accepts a plain version without one tap")
            t4["skipped_tap_max_diff"] = float((short.float() - ref.float()).abs().max())
            del short
        del out_bf, out_f32, ref_f32
        t4["ms"] = cuda_ms(lambda: conv.conv_taps_launch(
            x, w, scale_big, kt, torch.bfloat16, True, addend, bias), 10)
        t4["ms_f32_out"] = cuda_ms(lambda: conv.conv_taps_launch(
            x, w, scale, kt, torch.float32, channels_first=True), 10)
        t4["ms_bf16_ndhwc_out"] = cuda_ms(lambda: conv.conv_taps_launch(
            x, w, scale, kt, torch.bfloat16), 10)
        t4["plain_ms"] = cuda_ms(lambda: conv.conv_taps_plain(
            x, w, scale_big, kt, torch.bfloat16, channels_first=True, **vae_form),
            1, warmup=0)
        t4["bound_ms"], t4["bound_by"], ops = _conv_bound(shape, 1, 2, PEAK_INT8_OPS)
        t4["tops"] = ops / t4["ms"] / 1e9
        del x, w, scale, scale_big, addend, bias, out, ref
        torch.cuda.empty_cache()

        # K5 on bf16 operands of the same shape, against its plain version
        # and beside cuDNN's convolution of the same tensors
        x, w, _ = _conv_inputs(shape, gen, int8=False)
        out = conv.conv_taps(x, w, None, kt, torch.float32, channels_first=True)
        out_bf = conv.conv_taps(x, w, None, kt, torch.bfloat16, channels_first=True)
        torch.cuda.synchronize()
        ref = conv.conv_taps_plain(x, w, None, kt, torch.float32, channels_first=True)
        slack = _k5_bar(ref, kt, cin)
        err = float((out - ref).abs().max())
        ref_bf = ref.to(torch.bfloat16)
        over = float(((out_bf.float() - ref_bf.float()).abs()
                      - _bf16_ulp(ref_bf) - slack).max())
        if not (err <= slack and over <= 0 and bool(torch.isfinite(out).all())):
            raise AssertionError(
                f"K5 differs from its plain version at {shape}: max |diff| {err} "
                f"(bar {slack}), bf16 out over one ulp by {over}")
        worst_k5 = max(worst_k5, err)
        t5 = dict(shape=list(shape), max_abs_err=err, bar=slack)
        if main or kt == 1:
            short = conv.conv_taps_plain(x, w, None, kt, torch.float32,
                                         channels_first=True, skip_tap=kt * 9 // 2)
            miss = float((short - ref).abs().max())
            if miss <= slack:
                raise AssertionError("K5's bar accepts a plain version without one tap")
            t5["skipped_tap_max_diff"] = miss
            del short
        del out, out_bf, ref_bf
        t5["ms"] = cuda_ms(lambda: conv.conv_taps_launch(
            x, w, None, kt, torch.bfloat16, channels_first=True), 10)
        t5["ms_f32_out"] = cuda_ms(lambda: conv.conv_taps_launch(
            x, w, None, kt, torch.float32, channels_first=True), 10)
        t5["plain_ms"] = cuda_ms(lambda: conv.conv_taps_plain(
            x, w, None, kt, torch.bfloat16, channels_first=True), 1, warmup=0)
        t5["bound_ms"], t5["bound_by"], ops = _conv_bound(shape, 2, 2, PEAK_BF16_FLOPS)
        t5["tflops"] = ops / t5["ms"] / 1e9
        # the library's call on the same tensors: a VALID conv3d of the
        # padded input. x viewed NCDHW keeps channels_last_3d strides.
        w5 = w.view(kt, 3, 3, cout, cin).permute(3, 4, 0, 1, 2)
        x_cl, w_cl = x.permute(0, 4, 1, 2, 3), w5.contiguous(
            memory_format=torch.channels_last_3d)
        x_cf, w_cf = x_cl.contiguous(), w5.contiguous()
        lib = F.conv3d(x_cf, w_cf)
        lib_err = float((lib.float() - ref).abs().max())
        del lib, ref
        t5["library_ms"] = cuda_ms(lambda: F.conv3d(x_cf, w_cf), 10)
        t5["library_channels_last_ms"] = cuda_ms(lambda: F.conv3d(x_cl, w_cl), 10)
        t5["library_max_diff"] = lib_err
        t4["library_bf16_conv3d_ms"] = t5["library_ms"]
        del x, w, x_cl, w_cl, x_cf, w_cf, w5
        torch.cuda.empty_cache()
        for key, t in (("k4", t4), ("k5", t5)):
            rows[key].append(t)
            log(f"  {key.upper()} {shape}: " + json.dumps(
                {k: (round(v, 4) if isinstance(v, float) and k.endswith(("ms", "tops", "tflops"))
                     else v) for k, v in t.items() if k != "shape"}))
    ragged = conv_ragged_sweep(gen)
    nan = conv_nan_neighbours(gen)
    log(f"  ragged sweep: K4 equal in its three output forms and K5 within its bars "
        f"at {ragged['cases']} shapes (K5 worst error {ragged['k5_worst_rel_err']:.2e} "
        f"of max|ref|); NaN neighbours: {nan['clean_outputs_checked']} outputs that "
        "read no NaN equal K5's plain version")
    for c in (conv.launches_w8a8, conv.launches_w8a8_kt1, conv.launches_bf16):
        c.reset()
    log(f"phase 12 K4, K5: K4 equal to its plain version at {len(CONV_SHAPES)} shapes "
        f"(the VAE's form with offset term and bias, fp32 NCDHW and bf16 NDHWC "
        f"out), K5 worst max_abs_err {worst_k5:.3e} (bar "
        f"{K5_REL_TOL} of max|ref|, times sqrt 2 at Cin = 512; bf16 out within one "
        "ulp); a plain version "
        "without one tap is rejected by both; main shape "
        f"{list(CONV_SHAPES[0])}: K4 {rows['k4'][0]['ms']:.3f} ms (bound "
        f"{rows['k4'][0]['bound_ms']:.3f}), K5 {rows['k5'][0]['ms']:.3f} ms (bound "
        f"{rows['k5'][0]['bound_ms']:.3f}, cuDNN {rows['k5'][0]['library_ms']:.3f} NCDHW, "
        f"{rows['k5'][0]['library_channels_last_ms']:.3f} channels-last)")
    k4 = dict(rows["k4"][0], by_shape=rows["k4"], ragged_cases=ragged["cases"])
    k5 = dict(rows["k5"][0], by_shape=rows["k5"], max_abs_err=worst_k5,
              ragged_cases=ragged["cases"], nan_neighbours=nan)
    return k4, k5, _quantizer_kernel(gen)


def _quantizer_kernel(gen) -> dict:
    """The quantizer's pack pass against its plain version, at the input of
    K4's main shape (bf16 NCDHW with the two causal frames) and at a ragged
    one, with and without an equalization vector: equal codes."""
    from dove_tpu_torch.ops import conv3d_int8 as conv
    from dove_tpu_torch.ops import quant

    B, Fo, Ho, Wo, cin, _, kt = CONV_SHAPES[0]
    main_shape = (B, cin, Fo + kt - 1, Ho, Wo)
    timing = {}
    for shape, padding in ((main_shape, 1), ((1, 68, 3, 37, 53), 1),
                           ((1, 128, 2, 31, 45), 0)):
        x = torch.nn.functional.silu(
            torch.randn(shape, generator=gen, device="cuda") * 2).to(torch.bfloat16)
        for eq in (None, torch.rand(shape[1], generator=gen, device="cuda") + 0.5):
            s, m = quant.asym_grid(x, eq_inv=eq, channel_dim=1)
            out = conv.quantize_pack(x, s, m, eq, padding)
            torch.cuda.synchronize()
            ref = conv.quantize_pack_plain(x, s, m, eq, padding)
            wrong = int((out != ref).sum())
            max_err = float((out.int() - ref.int()).abs().max())
            if wrong or int(out.abs().max()) != 127:
                raise AssertionError(f"the quantizer's kernel differs from its plain "
                                     f"version at {shape} in {wrong} codes")
            if torch.equal(conv.quantize_pack_plain(x, s * 1.01, m, eq, padding), ref):
                raise AssertionError("the quantizer's bar accepts another grid")
            if shape == main_shape and eq is not None:  # the main path's form
                timing = dict(
                    shape=list(shape), max_abs_err=max_err,
                    ms=cuda_ms(lambda: conv.quantize_pack_launch(x, s, m, eq, padding), 10),
                    plain_ms=cuda_ms(lambda: conv.quantize_pack_plain(x, s, m, eq, padding),
                                     3),
                    search_ms=cuda_ms(lambda: quant.asym_grid(x, eq_inv=eq, channel_dim=1),
                                      10))
                nbytes = x.numel() * 2 + out.numel() + 4 * shape[1]
                timing.update(bound_ms=nbytes / PEAK_BYTES * 1e3, bound_by="bytes")
            del out, ref
        del x
    conv.launches_quantize.reset()
    torch.cuda.empty_cache()
    log(f"  quantizer's pack pass: equal to its plain version (bf16 in, with and "
        f"without equalization, padded and not); {json.dumps(timing)}")
    return timing


# ---------------------------------------------------------------------------
# Phases 13-15: the int8 VAE modes and the K5 route
# ---------------------------------------------------------------------------

def _conv_counters():
    from dove_tpu_torch.ops import conv3d_int8 as conv
    from dove_tpu_torch.ops import flash_attention as fa

    return {"k1": fa.launches, "k2": fa.launches_qk8, "k4": conv.launches_w8a8,
            "k4_kt1": conv.launches_w8a8_kt1, "k5": conv.launches_bf16,
            "quantize": conv.launches_quantize}


def _vae_passes(pipe, frames: int, h: int, w: int) -> tuple[int, int]:
    """(encoder forwards, decoder forwards) of one staged pass over an LQ
    clip: windows of the pipeline's plan times frame chunks."""
    from dove_tpu_torch import tiling
    from dove_tpu_torch.models.vae import _frame_chunks
    from dove_tpu_torch.pipeline import plan_axis

    cfg = pipe.config
    pad_f, pad_h, pad_w = tiling.compute_padding(frames, h, w)
    n_frames = tiling.next_valid_frames(frames + pad_f)
    lat_h = (h + pad_h) * cfg.upscale // cfg.vae.spatial_scale
    lat_w = (w + pad_w) * cfg.upscale // cfg.vae.spatial_scale
    blend, enc_max, dec_max = pipe._window_budget()

    def windows(budget):
        return plan_axis(lat_h, blend, budget[0])[2] * plan_axis(lat_w, blend, budget[1])[2]

    enc_chunks = len(_frame_chunks(n_frames, cfg.vae.sample_frames_batch_size))
    dec_chunks = len(_frame_chunks(cfg.vae.latent_frames(n_frames),
                                   cfg.vae.latent_frames_batch_size))
    return windows(enc_max) * enc_chunks, windows(dec_max) * dec_chunks


def predicted_conv_launches(pipe, frames: int, h: int, w: int) -> dict:
    """K4, K5 and quantizer launches of one staged pass, from the window plan: every
    conv module runs once per forward of its half of the VAE. K4 takes the
    stride-1 QConv3ds (the encoder's k_t = 1 ones are its stride-2
    downsamplers, an int8 matrix product); K5, when switched on, the float
    3x3x3 convs with both channel counts multiples of 128."""
    return _conv_launches(pipe, *_vae_passes(pipe, frames, h, w))


def _conv_launches(pipe, enc_passes: int, dec_passes: int) -> dict:
    """K4, K5 and quantizer launches of that many encoder and decoder
    forwards."""
    from dove_tpu_torch.ops.quant import QConv3d

    want = {"k4": 0, "k4_kt1": 0, "k5": 0, "quantize": 0}
    for half, passes in ((pipe.vae.encoder, enc_passes), (pipe.vae.decoder, dec_passes)):
        for mod in half.modules():
            if isinstance(mod, QConv3d):
                want["quantize"] += passes  # the stride-2 ones too
                if mod.kt == 3:
                    want["k4"] += passes
                elif half is pipe.vae.decoder:
                    want["k4_kt1"] += passes
            elif (pipe.hand_conv and isinstance(mod, torch.nn.Conv3d)
                  and tuple(mod.kernel_size) == (3, 3, 3)
                  and mod.in_channels % 128 == 0 and mod.out_channels % 128 == 0):
                want["k5"] += passes
    return want


def _largest_logged(shape_log: list) -> dict:
    """Per (Cin, Cout, k_t), the largest input the run gave the kernel, as a
    CONV_SHAPES tuple."""
    best: dict = {}
    for (B, F, Hp, Wp, cin), cout, kt in shape_log:
        key = (cin, cout, kt)
        shape = (B, F - (kt - 1), Hp - 2, Wp - 2, cin, cout, kt)
        if key not in best or math.prod(shape[:4]) > math.prod(best[key][:4]):
            best[key] = shape
    return best


def _two_layer_models():
    import dataclasses

    from dove_tpu_torch import cogvideox1_5_5b, init_dit_params, init_vae_params

    base = cogvideox1_5_5b()
    cfg = dataclasses.replace(base, dit=dataclasses.replace(base.dit, num_layers=2))
    dit = init_dit_params(cfg.dit, seed=0, device="cuda", dtype=torch.bfloat16)
    vae = init_vae_params(cfg.vae, seed=1, device="cuda", dtype=torch.bfloat16)
    return cfg, dit, vae


def phase_k4_pipeline() -> None:
    """Phase 3's model and clip with quantize="int8": W8A8 DiT with K2, every
    hot conv of encoder and decoder int8 (K4 at k_t = 3 and 1, the stride-2
    downsamplers as an int8 matrix product). Three runs share the models,
    quantized in place by the first: kernels, K4's plain version
    (conv_backend="plain"), K2's plain version ("plain-qk8")."""
    from dove_tpu_torch.ops import conv3d_int8 as conv

    cfg, dit, vae = _two_layer_models()
    clip = np.random.default_rng(3).uniform(0, 1, (9, 96, 160, 3)).astype(np.float32)
    counters = _conv_counters()
    outs = {}
    for name, backend, conv_backend in (("kernels", None, None),
                                        ("plain conv", None, "plain"),
                                        ("plain qk8", "plain-qk8", None)):
        pipe = _pipeline(cfg, dit, vae, backend, sample_posterior=False,
                         quantize="int8", conv_backend=conv_backend)
        for c in counters.values():
            c.reset()
        conv.shape_log = []
        torch.cuda.reset_peak_memory_stats()
        out = pipe.process_frames(clip, seed=0)
        outs[name] = (out, {n: c.count for n, c in counters.items()},
                      dict(pipe.stage_times), torch.cuda.max_memory_allocated())
        if name == "kernels":
            shapes = conv.shape_log
        conv.shape_log = None
    want = predicted_conv_launches(pipe, *clip.shape[:3])
    k_out, k_counts, k_times, k_peak = outs["kernels"]
    layers = cfg.dit.num_layers
    want_counts = {"kernels": dict(want, k1=0, k2=layers),
                   "plain conv": dict(k1=0, k2=layers, k4=0, k4_kt1=0, k5=0, quantize=0),
                   "plain qk8": dict(want, k1=0, k2=0)}
    for name, (_, counts, _, _) in outs.items():
        if counts != want_counts[name]:
            raise AssertionError(f"phase 13 launches in the {name} run: {counts}, "
                                 f"want {want_counts[name]}")
    if k_out.shape != (9, 384, 640, 3) or k_out.dtype != np.uint8 or not k_out.std() > 0:
        raise AssertionError(f"phase 13 output {k_out.shape} {k_out.dtype}")
    unsupported = [sh for sh in _largest_logged(shapes).values()
                   if sh[4] % 64 or sh[5] % 128]
    if len(shapes) != want["k4"] + want["k4_kt1"] or unsupported:
        raise AssertionError(f"phase 13 logged {len(shapes)} launches, {unsupported}")
    identical = bool(np.array_equal(k_out, outs["plain conv"][0]))
    psnr = psnr_u8(k_out, outs["plain qk8"][0])
    log(f"phase 13 int8 pipeline (2 layers, full width, int8 DiT + encoder + "
        f"decoder): K4 vs its plain version uint8 identical {identical}; K2 vs "
        f"plain-qk8 PSNR {psnr:.2f} dB (bar {PSNR_BAR_DB}); launches {k_counts} as "
        f"predicted from the window plan; output std {float(k_out.std()):.2f}, "
        f"stages {json.dumps({k: round(v, 3) for k, v in k_times.items()})} "
        f"(plain conv: {json.dumps({k: round(v, 3) for k, v in outs['plain conv'][2].items()})}), "
        f"peak {k_peak / 2**30:.2f} GiB")
    if not identical:
        diff = np.abs(k_out.astype(int) - outs["plain conv"][0].astype(int))
        raise AssertionError(f"phase 13: K4 and its plain version give different "
                             f"outputs (max {diff.max()} LSB, {(diff > 0).mean():.2%})")
    if not psnr >= PSNR_BAR_DB:
        raise AssertionError(f"phase 13 PSNR {psnr} below {PSNR_BAR_DB}")
    del dit, vae, pipe
    torch.cuda.empty_cache()


def phase_int8_dit_dec(profile_dir: str | None = None) -> dict:
    """The mode the JAX package recommends, as its bench serves it: int8 DiT,
    int8 decoder outside the "lowres" set, equalized from synthetic stats."""
    from dove_tpu_torch import cogvideox1_5_5b, init_dit_params, init_vae_params
    from dove_tpu_torch.ops import conv3d_int8 as conv
    from dove_tpu_torch.ops import quant

    resident = torch.cuda.memory_allocated()  # what earlier phases left: ~0
    cfg = cogvideox1_5_5b()
    t0 = time.perf_counter()
    dit = init_dit_params(cfg.dit, seed=0, device="cuda", dtype=torch.bfloat16)
    vae = init_vae_params(cfg.vae, seed=1, device="cuda", dtype=torch.bfloat16)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    pipe = _pipeline(cfg, dit, vae, None, sample_posterior=True,
                     quantize="int8-dit-dec", vae_exclude=("lowres",),
                     vae_calib=quant.synthetic_vae_calib(vae))
    torch.cuda.synchronize()
    quant_s = time.perf_counter() - t0
    del dit, vae
    qconvs = [m for m in pipe.vae.modules() if isinstance(m, quant.QConv3d)]
    if not qconvs or any(m.equalize_inv is None for m in qconvs) or any(
            isinstance(m, quant.QConv3d) for m in pipe.vae.encoder.modules()):
        raise AssertionError("int8-dit-dec did not quantize and equalize the decoder only")
    clip = np.random.default_rng(4).uniform(
        0, 1, (CLIP_FRAMES, CLIP_H, CLIP_W, 3)).astype(np.float32)
    counters = _conv_counters()
    want = dict(predicted_conv_launches(pipe, *clip.shape[:3]), k1=0,
                k2=cfg.dit.num_layers)
    for c in counters.values():
        c.reset()
    conv.shape_log = []
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = pipe.process_frames(clip, seed=0)
    wall = time.perf_counter() - t0
    counts = {n: c.count for n, c in counters.items()}
    shapes, conv.shape_log = conv.shape_log, None
    peak = torch.cuda.max_memory_allocated()
    expect = (CLIP_FRAMES, CLIP_H * cfg.upscale, CLIP_W * cfg.upscale, 3)
    if out.shape != expect or out.dtype != np.uint8 or float(out.std()) == 0.0:
        raise AssertionError(f"int8-dit-dec output {out.shape} {out.dtype}, want {expect}")
    if counts != want:
        raise AssertionError(f"phase 14 launches {counts}, want {want}")
    largest = _largest_logged(shapes)
    missing = [sh for sh in largest.values() if sh not in CONV_SHAPES]
    if missing or CONV_SHAPES[0] not in largest.values():
        raise AssertionError(f"phase 14 gave K4 shapes phase 12 did not check: {largest}")
    stage_s = {k: round(v, 3) for k, v in pipe.stage_times.items()}
    log(f"phase 14 int8-dit-dec main path (5B, {cfg.dit.num_layers} layers, W8A8 DiT, "
        f"{len(qconvs)} int8 decoder convs outside \"lowres\" ({len(pipe.vae_exclude)} "
        f"kept bf16), synthetic equalization; quantized in {quant_s:.1f}s, weights "
        f"init {init_s:.1f}s, {resident / 2**30:.2f} GiB held before the phase): "
        f"{CLIP_FRAMES} frames -> {expect[1]}x{expect[2]}, wall {wall:.2f}s, stages "
        f"{json.dumps(stage_s)}, launches {counts} as predicted, largest K4 inputs "
        f"{sorted(largest.values(), reverse=True)}, peak {peak / 2**30:.2f} GiB")
    if profile_dir is not None:
        profile_main_path(pipe, clip, profile_dir, "int8_dit_dec_main_path", "phase 14")
    del pipe
    torch.cuda.empty_cache()
    return dict(launches=counts, stage_s=stage_s, wall_s=wall, peak_bytes=peak)


def phase_hand_conv() -> dict:
    """K5 opt-in: phase 3's bf16 pipeline with the float VAE's eligible
    3x3x3 convs through K5 (hand_conv=True) and through cuDNN."""
    from dove_tpu_torch.models import vae as vae_mod

    cfg, dit, vae = _two_layer_models()
    clip = np.random.default_rng(3).uniform(0, 1, (9, 96, 160, 3)).astype(np.float32)
    counters = _conv_counters()
    outs = {}
    try:
        for hand in (False, True, False):  # the first run warms the card up
            pipe = _pipeline(cfg, dit, vae, None, sample_posterior=False, hand_conv=hand)
            for c in counters.values():
                c.reset()
            out = pipe.process_frames(clip, seed=0)
            counts = {n: c.count for n, c in counters.items()}
            want = dict(predicted_conv_launches(pipe, *clip.shape[:3]),
                        k1=cfg.dit.num_layers, k2=0)
            if counts != want or bool(want["k5"]) != hand:
                raise AssertionError(f"phase 15 hand_conv={hand}: launches {counts}, "
                                     f"want {want}")
            outs[hand] = (out, counts, dict(pipe.stage_times))
    finally:
        vae_mod.set_pallas_conv(False)
    psnr = psnr_u8(outs[True][0], outs[False][0])
    max_diff = int(np.abs(outs[True][0].astype(int) - outs[False][0].astype(int)).max())
    log(f"phase 15 K5 opt-in (bf16, 2 layers, full width): hand_conv on vs off "
        f"PSNR {psnr:.2f} dB (bar {PSNR_BAR_DB}), max |diff| {max_diff} LSB; K5 "
        f"launches {outs[True][1]['k5']} on (every eligible conv of every forward), "
        f"{outs[False][1]['k5']} off; stages on "
        f"{json.dumps({k: round(v, 3) for k, v in outs[True][2].items()})}, off "
        f"{json.dumps({k: round(v, 3) for k, v in outs[False][2].items()})}")
    if not psnr >= PSNR_BAR_DB:
        raise AssertionError(f"phase 15 PSNR {psnr} below {PSNR_BAR_DB}")
    del dit, vae, pipe
    torch.cuda.empty_cache()
    return dict(launches=outs[True][1]["k5"], stage_s=outs[True][2],
                stage_s_off=outs[False][2])


# ---------------------------------------------------------------------------
# Phases 18-20: the fused outer-tile path and scoring
# ---------------------------------------------------------------------------

def fused_plan(cfg, frames: int, h: int, w: int, upscale: int, tile_size_hw=(0, 0),
               chunk_len: int = 0, overlap_t: int = 8, overlap_hw=(32, 32),
               tile_batch: int = 1, **_) -> dict:
    """What DovePipeline's fused path will run on a clip, from the plan
    alone: its device calls (same-shaped tiles in batches of tile_batch) and
    the joint text+video tokens of each geometry's DiT pass."""
    from dove_tpu_torch import tiling

    pad_f, pad_h, pad_w = tiling.compute_padding(frames, h, w)
    tiles = tiling.plan_tiles(frames + pad_f, (h + pad_h) * upscale,
                              (w + pad_w) * upscale, chunk_len, tile_size_hw,
                              overlap_t, overlap_hw)
    geoms = tiling.tile_geometries(tiles)
    ratio, pt = cfg.vae.temporal_compression_ratio, cfg.dit.patch_size_t
    patch = cfg.vae.spatial_scale * cfg.dit.patch_size
    tokens = {}
    for f, th, tw in geoms:
        f = tiling.next_valid_frames(f)
        lat = f // ratio if f % (2 * ratio) == 0 else (f - 1) // ratio + 1
        lat += (pt - lat % pt) % pt
        tokens[(f, th, tw)] = (cfg.dit.max_text_seq_length
                               + lat // pt * (th // patch) * (tw // patch))
    calls = sum(-(-n // tile_batch) for n in geoms.values())
    return dict(tiles=len(tiles), geometries=len(geoms), calls=calls,
                max_tokens=max(tokens.values()), min_tokens=min(tokens.values()))


def _check_float_clip(out: np.ndarray, shape: tuple, what: str) -> None:
    if out.shape != shape or out.dtype != np.float32:
        raise AssertionError(f"{what}: output {out.shape} {out.dtype}, want {shape}")
    if not (np.isfinite(out).all() and out.min() >= 0.0 and out.max() <= 1.0):
        raise AssertionError(f"{what}: output not finite in [0, 1]")
    if float(out.std()) == 0.0:
        raise AssertionError(f"{what}: output is constant")


def _u8(x: np.ndarray) -> np.ndarray:
    return np.round(x * 255.0).astype(np.uint8)


def _drive_fused(pipe, clip: np.ndarray, **kw) -> tuple[np.ndarray, dict]:
    """process_frames with what the run did measured: the device calls and
    their tile shapes (sr_tile wrapped on this pipeline), every kernel's
    launches, and the q shapes K1 and K2 were launched at (the counters'
    shape records)."""
    from dove_tpu_torch.ops import flash_attention as fa

    calls = []
    sr_tile = pipe.sr_tile
    pipe.sr_tile = lambda tile, gen: calls.append(tuple(tile.shape)) or sr_tile(tile, gen)
    counters = _conv_counters()
    for c in counters.values():
        c.reset()
    fa.launches.shapes, fa.launches_qk8.shapes = [], []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    try:
        out = pipe.process_frames(clip, **kw)
        wall = time.perf_counter() - t0
        q_shapes = fa.launches.shapes + fa.launches_qk8.shapes
    finally:
        del pipe.sr_tile
        fa.launches.shapes = fa.launches_qk8.shapes = None
    tokens = [shape[2] for shape in q_shapes]
    rec = dict(wall_s=wall, calls=len(calls), call_shapes=calls,
               tile_shapes=sorted(set(calls)),
               q_shapes=sorted(set(q_shapes)),
               min_tokens=min(tokens, default=None), max_tokens=max(tokens, default=None),
               peak_bytes=torch.cuda.max_memory_allocated(),
               **{n: c.count for n, c in counters.items()})
    return out, rec


def _check_attention_launches(rec: dict, kernel: str | None, layers: int,
                              plan: dict | None, what: str,
                              passes: int | None = None) -> None:
    """One launch of ``kernel`` ("k1", "k2" or None) per layer per DiT pass
    and none of the other: a pass per measured device call of the fused
    path, or ``passes`` on the staged path; the plan's calls and token range
    held to the measured ones as a second check."""
    passes = rec["calls"] if passes is None else passes
    want = {"k1": 0, "k2": 0}
    if kernel is not None:
        want[kernel] = layers * passes
    got = {"k1": rec["k1"], "k2": rec["k2"]}
    if got != want or passes == 0:
        raise AssertionError(f"{what}: launches {got} over {passes} DiT passes, "
                             f"want {want}")
    if plan is None:
        return
    measured = dict(calls=rec["calls"])
    planned = dict(calls=plan["calls"])
    if kernel is not None:
        measured.update(min_tokens=rec["min_tokens"], max_tokens=rec["max_tokens"])
        planned.update(min_tokens=plan["min_tokens"], max_tokens=plan["max_tokens"])
    if measured != planned:
        raise AssertionError(f"{what}: measured {measured}, the plan says {planned}")


def _fused_conv_launches(pipe, tile_shapes: list) -> dict:
    """K4 and quantizer launches of the fused path's measured device calls:
    each call encodes its tile in frame chunks and decodes its latents in
    latent chunks, the batch of tiles in one launch per conv."""
    from dove_tpu_torch.models.vae import _frame_chunks

    vcfg = pipe.config.vae
    want = {"k4": 0, "k4_kt1": 0, "k5": 0, "quantize": 0}
    for _, frames, _, _, _ in tile_shapes:
        enc = len(_frame_chunks(frames, vcfg.sample_frames_batch_size))
        dec = len(_frame_chunks(vcfg.latent_frames(frames),
                                vcfg.latent_frames_batch_size))
        for key, n in _conv_launches(pipe, enc, dec).items():
            want[key] += n
    return want


def _fused_upscale_modes(cfg, dit, vae, prompt) -> dict:
    """The fused path under each --upscale_mode but bilinear, at 2 layers on
    a 9x64x128 clip through K1, its launches held to layers x the measured
    calls; each mode's device resize (``_upscale_input``) held to the same
    op on the CPU tensor at tests/test_torch_resize.py's bars (doubled: the
    input is mapped to [-1, 1])."""
    from types import SimpleNamespace

    from dove_tpu_torch.io.video import UPSCALE_MODES
    from dove_tpu_torch.pipeline import DovePipeline

    layers = cfg.dit.num_layers
    small = np.random.default_rng(22).uniform(0, 1, (9, 64, 128, 3)).astype(np.float32)
    plan = fused_plan(cfg, *small.shape[:3], cfg.upscale, **FUSED_2L)
    pipe = DovePipeline(config=cfg, dit=dit, vae=vae, prompt_embedding=prompt,
                        dtype=torch.bfloat16, device="cuda", sample_posterior=False)
    cpu = SimpleNamespace(device=torch.device("cpu"))
    out = {}
    for mode in ("bicubic", "nearest", "area", "lanczos"):
        dev = pipe._upscale_input(small, cfg.upscale, mode).cpu()
        ref = DovePipeline._upscale_input(cpu, small, cfg.upscale, mode)
        err = float((dev - ref).abs().max())
        if not err <= 2 * RESIZE_ATOL[UPSCALE_MODES[mode]]:
            raise AssertionError(f"phase 18 {mode}: the device resize is {err:.3e} "
                                 "from the CPU's")
        clip, rec = _drive_fused(pipe, small, seed=0, upscale_mode=mode, **FUSED_2L)
        _check_float_clip(clip, (9, 256, 512, 3), f"phase 18 {mode}")
        _check_attention_launches(rec, "k1", layers, plan, f"phase 18 {mode} run")
        out[mode] = dict(resize_max_abs_err=err, k1=rec["k1"], calls=rec["calls"],
                         wall_s=rec["wall_s"])
    log("phase 18 fused path per --upscale_mode (2 layers, full width, 9x64x128 -> "
        "256x512 through K1, the resize on the card): " + json.dumps(
            {m: {k: (f"{v:.2e}" if k.endswith("err") else rounded(v, 3))
                 for k, v in r.items()} for m, r in out.items()}))
    del pipe
    return out


def phase_fused_kernel_vs_plain() -> dict:
    """The fused path at full widths and 2 DiT layers on a 17-frame 180x320
    clip (32 frames until the run outgrew its time limit), in 256x256 tiles
    of 16-frame chunks, two tiles a call: every DiT
    pass is under 2048 tokens (measured from K1's launches), where the
    automatic rule would take the naive attention; the fused path takes K1.
    Once through the kernels and once through attention_backend="plain",
    then the same under int8-dit with K2 against "plain-qk8", compared by
    PSNR; the launches held to layers x the measured calls. Then the fused
    path under quantize="int8" on a 9x64x128 clip (two geometries): K4 on
    the tiles' convs against its plain version, K2 against "plain-qk8". Then
    the staged path with --upscale 1 on a 720x1280 input, the pipeline built
    by the CLI's load_pipeline."""
    from dove_tpu_torch.inference import build_parser, load_pipeline
    from dove_tpu_torch.ops import flash_attention as fa
    from dove_tpu_torch.pipeline import DovePipeline

    cfg, dit, vae = _two_layer_models()
    layers = cfg.dit.num_layers
    clip = np.random.default_rng(18).uniform(
        0, 1, (FUSED_2L_FRAMES, CLIP_H, CLIP_W, 3)).astype(np.float32)
    plan = fused_plan(cfg, FUSED_2L_FRAMES, CLIP_H, CLIP_W, cfg.upscale, **FUSED_2L)
    prompt = torch.zeros((cfg.dit.max_text_seq_length, cfg.dit.text_embed_dim),
                         dtype=torch.bfloat16)
    expect = (FUSED_2L_FRAMES, CLIP_H * cfg.upscale, CLIP_W * cfg.upscale, 3)
    result = {"modes": _fused_upscale_modes(cfg, dit, vae, prompt)}
    for mode, backends in ((None, (None, "plain")), ("int8-dit", (None, "plain-qk8"))):
        outs = {}
        for backend in backends:  # the int8 runs share the DiT quantized by the first
            pipe = DovePipeline(
                config=cfg, dit=dit, vae=vae, prompt_embedding=prompt,
                dtype=torch.bfloat16, device="cuda", attention_backend=backend,
                sample_posterior=False, quantize=mode)
            out, rec = _drive_fused(pipe, clip, seed=0, **FUSED_2L)
            _check_float_clip(out, expect, f"phase 18 {mode} {backend}")
            outs[backend] = (out, rec)
        (k_out, k_rec), (p_out, p_rec) = outs.values()
        name = mode or "bf16"
        _check_attention_launches(k_rec, "k1" if mode is None else "k2", layers,
                                  plan, f"phase 18 {name} kernel run")
        _check_attention_launches(p_rec, None, layers, plan,
                                  f"phase 18 {name} {backends[1]} run")
        if not k_rec["max_tokens"] < 2048:
            raise AssertionError(f"phase 18 tiles reach {k_rec['max_tokens']} tokens")
        psnr = psnr_u8(_u8(k_out), _u8(p_out))
        max_diff = float(np.abs(k_out - p_out).max())
        log(f"phase 18 fused path {name} (2 layers, full width, {plan['tiles']} "
            f"tiles in {plan['geometries']} geometries; measured: {k_rec['calls']} "
            f"calls of {len(k_rec['tile_shapes'])} tile shapes, K1/K2 at "
            f"{k_rec['min_tokens']}-{k_rec['max_tokens']} tokens): kernels vs "
            f"{backends[1]} PSNR {psnr:.2f} dB (bar {PSNR_BAR_DB}), max |diff| "
            f"{max_diff:.4f}, launches K1 {k_rec['k1']} K2 {k_rec['k2']}, wall "
            f"{k_rec['wall_s']:.2f}s (plain {p_rec['wall_s']:.2f}s)")
        if not psnr >= PSNR_BAR_DB:
            raise AssertionError(f"phase 18 {name} PSNR {psnr} below {PSNR_BAR_DB}")
        result[name] = dict(psnr_db=psnr, k1=k_rec["k1"], k2=k_rec["k2"],
                            calls=k_rec["calls"], tokens=[k_rec["min_tokens"],
                                                          k_rec["max_tokens"]],
                            wall_s=k_rec["wall_s"], plain_wall_s=p_rec["wall_s"])
        del pipe, outs, k_out, p_out

    # quantize="int8": K4 on the tiles' encoder and decoder convs, K2 in the DiT
    small = np.random.default_rng(21).uniform(0, 1, (9, 64, 128, 3)).astype(np.float32)
    small_plan = fused_plan(cfg, *small.shape[:3], cfg.upscale, **FUSED_2L)
    outs = {}
    for name, backend, conv_backend in (("kernels", None, None),
                                        ("plain conv", None, "plain"),
                                        ("plain qk8", "plain-qk8", None)):
        pipe = _pipeline(cfg, dit, vae, backend, sample_posterior=False,
                         quantize="int8", conv_backend=conv_backend)
        out, rec = _drive_fused(pipe, small, seed=0, **FUSED_2L)
        _check_float_clip(out, (9, 256, 512, 3), f"phase 18 int8 {name}")
        outs[name] = (out, rec)
    k_out, k_rec = outs["kernels"]
    convs = _fused_conv_launches(pipe, k_rec["call_shapes"])
    del pipe
    no_conv = dict(k4=0, k4_kt1=0, k5=0, quantize=0)
    for name, kernel, want in (("kernels", "k2", convs), ("plain conv", "k2", no_conv),
                               ("plain qk8", None, convs)):
        rec = outs[name][1]
        _check_attention_launches(rec, kernel, layers, small_plan,
                                  f"phase 18 int8 {name} run")
        got = {n: rec[n] for n in want}
        if got != want or (name == "kernels" and not got["k4"] > 0):
            raise AssertionError(f"phase 18 int8 {name} run: conv launches {got}, "
                                 f"want {want}")
    identical = bool(np.array_equal(k_out, outs["plain conv"][0]))
    psnr = psnr_u8(_u8(k_out), _u8(outs["plain qk8"][0]))
    log(f"phase 18 fused path int8 (2 layers, full width, int8 DiT + encoder + "
        f"decoder, 9x64x128 -> 256x512; measured: {k_rec['calls']} calls, tiles "
        f"{k_rec['tile_shapes']}): K4 vs its plain version identical {identical}; "
        f"K2 vs plain-qk8 PSNR {psnr:.2f} dB (bar {PSNR_BAR_DB}); launches "
        f"{json.dumps({n: k_rec[n] for n in ('k1', 'k2', *convs)})} as the measured "
        f"calls give; wall {k_rec['wall_s']:.2f}s")
    if not identical:
        diff = np.abs(k_out - outs["plain conv"][0])
        raise AssertionError(f"phase 18 int8: K4 and its plain version give "
                             f"different outputs (max {diff.max():.3e})")
    if not psnr >= PSNR_BAR_DB:
        raise AssertionError(f"phase 18 int8 PSNR {psnr} below {PSNR_BAR_DB}")
    result["int8"] = dict(psnr_db=psnr, k2=k_rec["k2"], k4=k_rec["k4"],
                          k4_kt1=k_rec["k4_kt1"], calls=k_rec["calls"])
    del outs, k_out, dit, vae
    torch.cuda.empty_cache()

    # the staged path at --upscale 1 through the CLI's loader: 42 layers
    args = build_parser().parse_args(
        ["--input_dir", ".", "--is_vae_st", "--upscale", "1", "--png_save"])
    pipe = load_pipeline(args)
    up1 = np.random.default_rng(19).uniform(0, 1, (9, 720, 1280, 3)).astype(np.float32)
    fa.launches.reset()
    t0 = time.perf_counter()
    out = pipe.process_frames(up1, seed=args.seed, upscale=args.upscale)
    wall = time.perf_counter() - t0
    n_layers = pipe.config.dit.num_layers
    if out.shape != (9, 720, 1280, 3) or out.dtype != np.uint8 or out.std() == 0:
        raise AssertionError(f"phase 18 upscale 1: output {out.shape} {out.dtype}")
    if fa.launches.count != n_layers:
        raise AssertionError(f"phase 18 upscale 1: K1 launches {fa.launches.count}")
    log(f"phase 18 staged --upscale 1 via load_pipeline ({n_layers} layers): 9x720x1280 "
        f"-> {out.shape} uint8, K1 launches {fa.launches.count}, wall {wall:.2f}s, "
        f"stages {json.dumps({k: round(v, 3) for k, v in pipe.stage_times.items()})}")
    result["upscale1"] = dict(wall_s=wall, k1=fa.launches.count)
    del pipe
    torch.cuda.empty_cache()
    return result


def _attention_at(q_shapes: list) -> dict:
    """K1 (bounded, as the DiT calls it) and K2 against their plain versions
    at each q shape a run launched them at, on seeded unit-normal q, k, v."""
    from dove_tpu_torch.ops import flash_attention as fa

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(19)
    scale = 64 ** -0.5
    worst = {"k1": 0.0, "k2": 0.0}
    for shape in q_shapes:
        q, k, v = (torch.randn(shape, generator=gen, device=dev, dtype=torch.bfloat16)
                   for _ in range(3))
        q8, k8, factor = fa.quantize_qk_pair(q, k, scale)
        for name, out, ref in (
                ("k1", fa.flash_attention(q, k, v, scale=scale, bounded_logits=True),
                 fa.flash_attention_plain(q, k, v, scale, bounded_logits=True)),
                ("k2", fa.flash_qk8_launch(q8, k8, v, factor),
                 fa.flash_attention_qk8_plain(q8, k8, v, factor))):
            err = attn_errors(out, ref)
            if not bool(torch.isfinite(out).all()) or not within_bars(err):
                raise AssertionError(f"{name} disagrees with its plain version at "
                                     f"{list(shape)}: {err}")
            worst[name] = max(worst[name], err["max_abs"])
        del q, k, v, q8, k8
    return worst


def phase_fused_main_path() -> dict:
    """The fused path at full width and depth: CogVideoX1.5-5B, 42 layers,
    seeded bf16 weights, built by the CLI's load_pipeline from the CLI
    docstring's flags (384x384 tiles, 16-frame chunks) and run with the
    flags main() forwards, on the 32-frame clip of phase 4: through the
    kernels, then through attention_backend="plain" on the same weights,
    compared by PSNR. Then the same clip untiled (tile_size_hw 0 0, in the
    CLI's 16-frame chunks) and through the staged path, for seconds and peak
    memory side by side. Last, K1 and K2 against their plain versions at
    every q shape the fused and untiled runs launched K1 at."""
    from dove_tpu_torch.inference import build_parser, load_pipeline, process_kwargs

    args = build_parser().parse_args(["--input_dir", "."] + FUSED_CLI)
    t0 = time.perf_counter()
    pipe = load_pipeline(args)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    cfg = pipe.config
    layers = cfg.dit.num_layers
    kw = process_kwargs(args)
    clip = np.random.default_rng(4).uniform(
        0, 1, (CLIP_FRAMES, CLIP_H, CLIP_W, 3)).astype(np.float32)
    expect = (CLIP_FRAMES, CLIP_H * cfg.upscale, CLIP_W * cfg.upscale, 3)

    def run(what: str, kernel: str | None, plan: dict | None,
            passes: int | None = None, **over):
        out, rec = _drive_fused(pipe, clip, **{**kw, **over})
        _check_attention_launches(rec, kernel, layers, plan, f"phase 19 {what}",
                                  passes)
        _check_float_clip(out, expect, f"phase 19 {what}")
        log(f"  phase 19 {what}: {rec['wall_s']:.2f}s, {rec['calls']} sr_tile calls, K1 "
            f"launches {rec['k1']} at {rec['min_tokens']}-{rec['max_tokens']} "
            f"tokens, peak {rec['peak_bytes'] / 2**30:.2f} GiB")
        return out, rec

    plan = fused_plan(cfg, CLIP_FRAMES, CLIP_H, CLIP_W, **kw)
    fused, warm = run("fused", "k1", plan)
    pipe.attention_backend = "plain"
    plain_out, plain = run("fused, plain attention", None, plan)
    pipe.attention_backend = None
    psnr = psnr_u8(_u8(fused), _u8(plain_out))
    max_diff = float(np.abs(fused - plain_out).max())
    del plain_out
    log(f"  phase 19 kernels vs plain attention: PSNR {psnr:.2f} dB (bar "
        f"{PSNR_BAR_DB}), max |diff| {max_diff:.4f}")
    if not psnr >= PSNR_BAR_DB:
        raise AssertionError(f"phase 19 kernels vs plain PSNR {psnr} below {PSNR_BAR_DB}")
    # one spatial tile, the CLI's 16-frame chunks: the whole 33-frame clip in
    # one call does not fit the card (its decoder asked for 15.47 GiB more
    # with 67.78 GiB in use on an NVIDIA H100 80GB HBM3 at 700 W, PERF.md)
    untiled_kw = dict(tile_size_hw=(0, 0))
    untiled_plan = fused_plan(cfg, CLIP_FRAMES, CLIP_H, CLIP_W, **{**kw, **untiled_kw})
    _, untiled = run("untiled", "k1", untiled_plan, **untiled_kw)
    pipe.vae_tiling = True  # the staged path on the same weights
    # one DiT pass over the whole clip, no sr_tile call
    staged, staged_rec = run("staged", "k1", None, passes=1, tile_size_hw=(0, 0),
                             chunk_len=0)
    staged_rec["stages_s"] = dict(pipe.stage_times)
    del pipe
    torch.cuda.empty_cache()
    shapes = sorted(set(warm["q_shapes"]) | set(untiled["q_shapes"]))
    t0 = time.perf_counter()
    worst = _attention_at(shapes)
    held_s = time.perf_counter() - t0

    def gib(rec):
        return f"{rec['peak_bytes'] / 2**30:.2f} GiB"

    log(f"phase 19 fused main path (5B, {layers} layers, bf16, load_pipeline "
        f"{' '.join(FUSED_CLI)}; measured: {warm['calls']} calls of "
        f"{len(warm['tile_shapes'])} tile shapes, K1 at {warm['min_tokens']}-"
        f"{warm['max_tokens']} tokens): {warm['wall_s']:.2f}s, K1 launches "
        f"{warm['k1']}, peak {gib(warm)}; kernels vs plain attention PSNR "
        f"{psnr:.2f} dB (bar {PSNR_BAR_DB}), max |diff| {max_diff:.4f}, plain "
        f"{plain['wall_s']:.2f}s; untiled in 16-frame chunks ({untiled['calls']} "
        f"calls, {untiled['min_tokens']}-{untiled['max_tokens']} tokens) "
        f"{untiled['wall_s']:.2f}s, peak {gib(untiled)}; staged "
        f"{staged_rec['wall_s']:.2f}s, peak {gib(staged_rec)}, stages "
        f"{json.dumps({k: round(v, 3) for k, v in staged_rec['stages_s'].items()})}; "
        f"K1 and K2 within the bars at the {len(shapes)} q shapes launched "
        f"{[list(sh) for sh in shapes]}, worst max_abs_err "
        f"{json.dumps({k: float(f'{x:.3e}') for k, x in worst.items()})} "
        f"({held_s:.1f}s); init {init_s:.1f}s")
    return dict(plan=plan, warm=warm, plain=plain, psnr_db=psnr, untiled=untiled,
                untiled_plan=untiled_plan, staged=staged_rec, held_shapes=shapes,
                held_worst=worst, fused_out=fused, staged_out=staged)


def _seeded_metric_weights(out_dir) -> dict[str, str]:
    """LPIPS and DISTS state dicts from a seeded VGG16 and seeded heads,
    written in the exported layouts (torchvision ``features.*``, lpips's
    ``lin{k}``), as the env vars the metric factories read."""
    from pathlib import Path

    from dove_tpu_torch import safetensors_io
    from dove_tpu_torch.eval import vgg as vgg_mod

    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    vgg = vgg_mod.init_vgg16(0, "cpu")
    convs = [c for stage in vgg.stages for c in stage]
    idx = (0, 2, 5, 7, 10, 12, 14, 17, 19, 21, 24, 26, 28)
    sd = {}
    for i, conv in zip(idx, convs):
        sd[f"features.{i}.weight"] = conv.weight.detach().contiguous()
        sd[f"features.{i}.bias"] = conv.bias.detach().contiguous()
    gen = torch.Generator().manual_seed(20)
    chans = [3] + [c for c, _ in vgg_mod.VGG16_STAGES]
    dists = dict(sd, alpha=torch.rand((1, sum(chans), 1, 1), generator=gen),
                 beta=torch.rand((1, sum(chans), 1, 1), generator=gen))
    lpips = dict(sd)
    for k, (c, _) in enumerate(vgg_mod.VGG16_STAGES):
        lpips[f"lin{k}.model.1.weight"] = torch.rand((1, c, 1, 1), generator=gen)
    paths = {}
    for name, tensors, env in (("dists", dists, "DOVE_DISTS_WEIGHTS"),
                               ("lpips", lpips, "DOVE_LPIPS_WEIGHTS")):
        path = out_dir / f"{name}.safetensors"
        safetensors_io.save_file(tensors, path)
        paths[env] = str(path)
    return paths


def phase_scoring(fused: np.ndarray, staged: np.ndarray) -> dict:
    """Scoring on the card: a MetricAccumulator with psnr, ssim, lpips and
    dists scores phase 19's fused clip against its staged clip (LPIPS and
    DISTS on seeded VGG16 state dicts this phase writes); both clips are
    written with save_frames_as_png, and ``python -m
    dove_tpu_torch.eval_metrics`` on those folders must give the same
    averages as the accumulator on the same 8-bit frames."""
    import os
    import shutil
    from pathlib import Path

    from dove_tpu_torch.eval.metrics import MetricAccumulator
    from dove_tpu_torch.io import video as video_io

    root = Path("build/chip_smoke_eval")
    shutil.rmtree(root, ignore_errors=True)
    env = _seeded_metric_weights(root / "weights")
    os.environ.update(env)
    names = ["psnr", "ssim", "lpips", "dists"]
    # the frames as the PNGs hold them
    pred = video_io._to_uint8(fused).astype(np.float32) / 255.0
    gt = video_io._to_uint8(staged).astype(np.float32) / 255.0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    acc = MetricAccumulator(names, device="cuda")
    vals = acc.add("clip", pred, gt)
    torch.cuda.synchronize()
    score_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    t0 = time.perf_counter()
    video_io.save_frames_as_png(fused, root / "pred" / "clip")
    video_io.save_frames_as_png(staged, root / "gt" / "clip")
    png_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    res = subprocess.run(
        [sys.executable, "-m", "dove_tpu_torch.eval_metrics",
         "--pred_dir", str(root / "pred"), "--gt_dir", str(root / "gt"),
         "--metrics", ",".join(names), "--output", str(root / "metrics.json")],
        env={**os.environ, **env}, capture_output=True, text=True, timeout=600)
    cli_s = time.perf_counter() - t0
    if res.returncode != 0:
        raise AssertionError(f"phase 20 eval_metrics failed: {res.stderr[-3000:]}")
    cli = json.loads((root / "metrics.json").read_text())
    errs = {n: abs(cli["average"][n] - vals[n]) / max(abs(vals[n]), 1e-30)
            for n in names}
    log(f"phase 20 scoring ({CLIP_FRAMES}x720x1280, fused vs staged, seeded "
        f"VGG16): {json.dumps(rounded(vals, 6))} in {score_s:.2f}s on the card "
        f"(peak {peak / 2**30:.2f} GiB); eval_metrics CLI on the PNG folders "
        f"{json.dumps(rounded(cli['average'], 6))} in {cli_s:.1f}s (count "
        f"{cli['count']}), rel diffs {json.dumps({k: f'{v:.1e}' for k, v in errs.items()})}; "
        f"PNG write {png_s:.1f}s")
    if cli["count"] != 1 or cli["per_sample_names"] != ["clip"]:
        raise AssertionError(f"phase 20 eval_metrics counted {cli['count']}")
    bad = {n: e for n, e in errs.items() if not e <= SCORE_REL_TOL[n]}
    if bad:
        raise AssertionError(f"phase 20 CLI and accumulator disagree: {bad}")
    if not all(math.isfinite(v) for v in vals.values()):
        raise AssertionError(f"phase 20 scores {vals}")
    return dict(scores=vals, cli=cli["average"], score_s=score_s, cli_s=cli_s,
                peak_bytes=peak)


def _renamed(module, rules) -> dict:
    """A module's state dict under a published layout's names: each name's
    first matching (pattern, replacement) regex rule applied."""
    import re

    out = {}
    for name, t in module.state_dict().items():
        for pat, rep in rules:
            if re.fullmatch(pat, name):
                name = re.sub(pat, rep, name)
                break
        out[name] = t.detach().clone().contiguous()
    return out


def _seeded_bn(sd: dict, prefix: str, c: int, gen) -> None:
    sd[f"{prefix}.weight"] = 1 + 0.1 * torch.randn(c, generator=gen)
    sd[f"{prefix}.bias"] = 0.1 * torch.randn(c, generator=gen)
    sd[f"{prefix}.running_mean"] = 0.1 * torch.randn(c, generator=gen)
    sd[f"{prefix}.running_var"] = torch.rand(c, generator=gen) + 0.5
    sd[f"{prefix}.num_batches_tracked"] = torch.tensor(0)


def _raft_things_sd(gen) -> dict:
    """Seeded weights in raft-things.pth's layout at its full channels: the
    feature net on instance norms (no weights), the context net on
    BatchNorms with running statistics; He-normal convs, the flow head's
    last conv scaled by 0.01, so that the flow stays within a few pixels over
    the 12 iterations (at 1, the updates add up to ~50 px, every pixel fails
    the occlusion check and the score is 0)."""
    sd = {}

    def conv(name, cout, cin, kh, kw=None, scale=1.0):
        kw = kh if kw is None else kw
        sd[f"{name}.weight"] = (torch.randn(cout, cin, kh, kw, generator=gen)
                                * (2.0 / (kh * kw * cin)) ** 0.5 * scale)
        sd[f"{name}.bias"] = torch.zeros(cout)

    for net, out_ch in (("fnet", 256), ("cnet", 256)):
        norm = (lambda name, c: _seeded_bn(sd, name, c, gen)) if net == "cnet" else (
            lambda name, c: None)
        conv(f"{net}.conv1", 64, 3, 7)
        norm(f"{net}.norm1", 64)
        cin = 64
        for i, cout in ((1, 64), (2, 96), (3, 128)):
            for j in range(2):
                pre = f"{net}.layer{i}.{j}"
                conv(f"{pre}.conv1", cout, cin if j == 0 else cout, 3)
                conv(f"{pre}.conv2", cout, cout, 3)
                norm(f"{pre}.norm1", cout)
                norm(f"{pre}.norm2", cout)
                if j == 0 and i > 1:
                    conv(f"{pre}.downsample.0", cout, cin, 1)
                    norm(f"{pre}.norm3", cout)
            cin = cout
        conv(f"{net}.conv2", out_ch, 128, 1)
    e = "update_block.encoder"
    conv(f"{e}.convc1", 256, 324, 1)
    conv(f"{e}.convc2", 192, 256, 3)
    conv(f"{e}.convf1", 128, 2, 7)
    conv(f"{e}.convf2", 64, 128, 3)
    conv(f"{e}.conv", 126, 256, 3)
    for gate in "zrq":
        conv(f"update_block.gru.conv{gate}1", 128, 384, 1, 5)
        conv(f"update_block.gru.conv{gate}2", 128, 384, 5, 1)
    conv("update_block.flow_head.conv1", 256, 128, 3)
    conv("update_block.flow_head.conv2", 2, 256, 3, scale=0.01)
    conv("update_block.mask.0", 256, 128, 3)
    conv("update_block.mask.2", 576, 256, 1)
    return sd


def _seeded_nr_weights(out_dir) -> dict[str, str]:
    """Seeded checkpoints at the published widths, in the published
    layouts, as the env vars the no-reference metrics read: a HuggingFace
    CLIP ViT-B/32 snapshot and an OpenAI CLIP RN50 .pt (width 64, layers 3,
    4, 6, 3, 32 attention-pool heads, 1024 out), each beside a vocab.json /
    merges.txt that spells the two prompts; MUSIQ at MUSIQConfig(), MANIQA
    at MANIQAConfig() (the official module's names), RAFT at full channels
    (raft-things.pth's), and a NIQE .npz (seeded mean, SPD covariance).
    The modules start from torch's default initialisation under a seed."""
    import dataclasses
    from pathlib import Path

    from dove_tpu_torch import safetensors_io
    from dove_tpu_torch.eval import clip as tclip
    from dove_tpu_torch.eval import maniqa as tmaniqa
    from dove_tpu_torch.eval import musiq as tmusiq
    from dove_tpu_torch.eval.clip_tokenizer import write_bpe_files

    out_dir = Path(out_dir)
    gen = torch.Generator().manual_seed(21)
    torch.manual_seed(21)
    paths = {}

    def normal_(t, std):
        with torch.no_grad():
            t.copy_(torch.randn(t.shape, generator=gen) * std)

    # CLIP ViT-B/32 as a HF CLIPModel snapshot
    cfg = tclip.CLIPConfig()
    vit = tclip.CLIP(cfg)
    for t, std in ((vit.vision.class_embed, 0.02), (vit.vision.pos_embed, 0.02),
                   (vit.text.pos_embed, 0.01), (vit.text.token_embed.weight, 0.02)):
        normal_(t, std)
    hf = {"ln1": "layer_norm1", "ln2": "layer_norm2", "q": "self_attn.q_proj",
          "k": "self_attn.k_proj", "v": "self_attn.v_proj", "out": "self_attn.out_proj",
          "fc1": "mlp.fc1", "fc2": "mlp.fc2"}
    rules = [(rf"(vision|text)\.blocks\.(\d+)\.{ours}\.(weight|bias)",
              rf"\1_model.encoder.layers.\2.{theirs}.\3") for ours, theirs in hf.items()]
    rules += [(r"vision\.patch_embed\.weight", "vision_model.embeddings.patch_embedding.weight"),
              (r"vision\.class_embed", "vision_model.embeddings.class_embedding"),
              (r"vision\.pos_embed", "vision_model.embeddings.position_embedding.weight"),
              (r"vision\.pre_ln\.(.*)", r"vision_model.pre_layrnorm.\1"),
              (r"vision\.post_ln\.(.*)", r"vision_model.post_layernorm.\1"),
              (r"text\.token_embed\.weight", "text_model.embeddings.token_embedding.weight"),
              (r"text\.pos_embed", "text_model.embeddings.position_embedding.weight"),
              (r"text\.final_ln\.(.*)", r"text_model.final_layer_norm.\1")]
    vit_dir = out_dir / "clip_vit"
    write_bpe_files(vit_dir, ("good", "bad", "photo"), cfg.vocab_size)
    safetensors_io.save_file(_renamed(vit, rules), vit_dir / "model.safetensors")
    (vit_dir / "config.json").write_text(json.dumps({
        "projection_dim": cfg.projection_dim,
        "vision_config": {"image_size": cfg.image_size, "patch_size": cfg.patch_size,
                          "hidden_size": cfg.vision_width,
                          "num_hidden_layers": cfg.vision_layers,
                          "num_attention_heads": cfg.vision_heads},
        "text_config": {"vocab_size": cfg.vocab_size,
                        "max_position_embeddings": cfg.context_length,
                        "hidden_size": cfg.text_width, "num_hidden_layers": cfg.text_layers,
                        "num_attention_heads": cfg.text_heads}}))
    paths["vit"] = str(vit_dir)
    del vit

    # CLIP RN50 as an OpenAI state dict (BatchNorms with seeded statistics)
    rn50 = tclip.CLIP(dataclasses.replace(cfg, projection_dim=RN50_OUT),
                      tclip.VisionRN50(RN50_WIDTH, RN50_HEADS, RN50_OUT))
    normal_(rn50.text.pos_embed, 0.01)
    normal_(rn50.text.token_embed.weight, 0.02)
    sd = {}
    own = rn50.state_dict()
    for name, t in own.items():
        if name.endswith(".scale"):
            continue
        if name.endswith(".bias") and name.removesuffix(".bias") + ".scale" in own:
            _seeded_bn(sd, _openai_rn50_name(name.removesuffix(".bias")), t.shape[0], gen)
            continue
        sd[_openai_rn50_name(name)] = t.detach().clone()
    for i in range(cfg.text_layers):
        pre = f"transformer.resblocks.{i}"
        sd[f"{pre}.attn.in_proj_weight"] = torch.cat(
            [sd.pop(f"{pre}.attn.{n}.weight") for n in "qkv"])
        sd[f"{pre}.attn.in_proj_bias"] = torch.cat(
            [sd.pop(f"{pre}.attn.{n}.bias") for n in "qkv"])
    sd["text_projection"] = sd.pop("text_projection.weight").T.contiguous()
    sd["visual.attnpool.positional_embedding"] = torch.randn(
        50, 32 * RN50_WIDTH, generator=gen) * 0.01
    rn50_dir = out_dir / "clip_rn50"
    write_bpe_files(rn50_dir, ("good", "bad", "photo"), cfg.vocab_size)
    torch.save(sd, rn50_dir / "RN50.pt")
    paths["rn50"] = str(rn50_dir / "RN50.pt")
    del rn50, sd

    # MUSIQ in the canonical flat layout
    musiq = tmusiq.MUSIQ(tmusiq.MUSIQConfig())
    for t in (musiq.cls_token, musiq.spatial_embedding, musiq.scale_embedding):
        normal_(t, 0.02)
    blk = {"norm1": "norm1", "qkv": "attn.qkv", "proj": "attn.proj", "norm2": "norm2",
           "fc1": "mlp.fc1", "fc2": "mlp.fc2"}
    torch.save(_renamed(musiq, [(rf"blocks\.(\d+)\.{o}\.(.*)", rf"transformer.\1.{t}.\2")
                                for o, t in blk.items()]), out_dir / "musiq.pt")
    paths["musiq"] = str(out_dir / "musiq.pt")
    del musiq

    # MANIQA in the official module's layout
    mcfg = tmaniqa.MANIQAConfig()
    maniqa = tmaniqa.MANIQA(mcfg)
    normal_(maniqa.cls_token, 0.02)
    normal_(maniqa.pos_embed, 0.02)
    for stage in (maniqa.swin1, maniqa.swin2):
        for layer in stage.layers:
            for b in layer:
                normal_(b.rel_bias_table, 0.02)
    rules = [(rf"blocks\.(\d+)\.{o}\.(.*)", rf"vit.blocks.\1.{t}.\2") for o, t in blk.items()]
    rules += [(rf"swin([12])\.layers\.(\d+)\.(\d+)\.{o}\.(.*)",
               rf"swintransformer\1.layers.\2.blocks.\3.{t}.\4") for o, t in blk.items()]
    rules += [(r"swin([12])\.layers\.(\d+)\.(\d+)\.rel_bias_table",
               r"swintransformer\1.layers.\2.blocks.\3.attn.relative_position_bias_table"),
              (r"patch_embed\.(.*)", r"vit.patch_embed.proj.\1"),
              (r"fc_(score|weight)\.1\.(.*)", r"fc_\1.3.\2")]
    sd = _renamed(maniqa, rules)
    sd["vit.cls_token"] = sd.pop("cls_token")[None]
    sd["vit.pos_embed"] = sd.pop("pos_embed")[None]
    torch.save(sd, out_dir / "maniqa.pt")
    paths["maniqa"] = str(out_dir / "maniqa.pt")
    del maniqa, sd

    torch.save(_raft_things_sd(gen), out_dir / "raft-things.pth")
    rng = np.random.default_rng(21)
    a = rng.normal(0, 1, (36, 36))
    np.savez(out_dir / "niqe.npz", mu=rng.normal(0, 1, 36), cov=a @ a.T / 36 + 0.1 * np.eye(36))
    return {"DOVE_CLIP_WEIGHTS": paths["vit"], "DOVE_MUSIQ_WEIGHTS": paths["musiq"],
            "DOVE_MANIQA_WEIGHTS": paths["maniqa"],
            "DOVE_RAFT_WEIGHTS": str(out_dir / "raft-things.pth"),
            "DOVE_NIQE_PARAMS": str(out_dir / "niqe.npz"), "rn50": paths["rn50"]}


def _openai_rn50_name(name: str) -> str:
    """The port's RN50 CLIP tensor (or BatchNorm) name -> OpenAI's."""
    import re

    m = re.fullmatch(r"vision\.layers\.(\d+)\.(\d+)\.(.*)", name)
    if m:
        rest = m[3].replace("down_conv", "downsample.0").replace("down_bn", "downsample.1")
        return f"visual.layer{int(m[1]) + 1}.{m[2]}.{rest}"
    for pat, rep in (
            (r"vision\.(q|k|v|c)\.(weight|bias)", r"visual.attnpool.\1_proj.\2"),
            (r"vision\.(.*)", r"visual.\1"),
            (r"text\.token_embed\.weight", "token_embedding.weight"),
            (r"text\.pos_embed", "positional_embedding"),
            (r"text\.final_ln\.(.*)", r"ln_final.\1"),
            (r"text\.blocks\.(\d+)\.ln([12])\.(.*)", r"transformer.resblocks.\1.ln_\2.\3"),
            (r"text\.blocks\.(\d+)\.(q|k|v)\.(.*)", r"transformer.resblocks.\1.attn.\2.\3"),
            (r"text\.blocks\.(\d+)\.out\.(.*)", r"transformer.resblocks.\1.attn.out_proj.\2"),
            (r"text\.blocks\.(\d+)\.fc1\.(.*)", r"transformer.resblocks.\1.mlp.c_fc.\2"),
            (r"text\.blocks\.(\d+)\.fc2\.(.*)", r"transformer.resblocks.\1.mlp.c_proj.\2")):
        if re.fullmatch(pat, name):
            return re.sub(pat, rep, name)
    return name


def _raft_with_and_without_cudnn(path: str, frames: np.ndarray) -> dict:
    """Why RAFT skips cuDNN: the consecutive pairs of ``frames`` (ewarp's
    chunk) through RAFT with the convolutions on cuDNN and on PyTorch's own
    kernels (what ``raft_flow`` takes), each timed warm, in full fp32."""
    from dove_tpu_torch.eval.vgg import full_fp32
    from dove_tpu_torch.models import raft as traft

    w = traft.load_raft(path, "cuda")
    x = torch.as_tensor(frames, device="cuda")
    out = {}
    with torch.no_grad(), full_fp32():
        for name, fn in (("cudnn", traft._raft_flow), ("native", traft.raft_flow)):
            for _ in range(2):  # the second call is timed
                torch.cuda.synchronize()
                t = time.perf_counter()
                out[name] = fn(w, x[:-1], x[1:], RAFT_CUDNN_ITERS)
                torch.cuda.synchronize()
                out[f"{name}_s"] = time.perf_counter() - t
    out["max_abs_diff"] = float((out.pop("cudnn") - out.pop("native")).abs().max())
    return out


def phase_nr_scoring(png_dir) -> dict:
    """The no-reference scores on the card: phase 19's fused 32-frame 720p
    clip, read back from its PNG dump (phase 20's), scored by clipiqa (ViT),
    niqe, musiq, maniqa and ewarp on seeded checkpoints at the published
    widths, through ``python -m dove_tpu_torch.eval_metrics`` with no
    --gt_dir (the VideoLQ route of scripts/inference.sh) and in-process
    through a MetricAccumulator: the same scores within NR_REL_TOL, every
    one finite, clipiqa in (0, 1); then clipiqa on the RN50 .pt, both ways.
    The CLI's child reports that it imported no cv2 and no transformers.
    Seconds and peak memory per metric are the in-process run's."""
    import os
    import shutil
    from pathlib import Path

    from dove_tpu_torch.eval.ewarp import PAIR_CHUNK
    from dove_tpu_torch.eval.metrics import MetricAccumulator
    from dove_tpu_torch.io.video import load_sequence

    root = Path("build/chip_smoke_nr")
    shutil.rmtree(root, ignore_errors=True)
    t0 = time.perf_counter()
    env = _seeded_nr_weights(root / "weights")
    rn50 = env.pop("rn50")
    weights_s = time.perf_counter() - t0
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    frames = load_sequence(Path(png_dir) / "clip")

    def in_process(names) -> tuple[dict, dict]:
        acc = MetricAccumulator(names, device="cuda")
        stats = {}
        for name, fn in list(acc._fns.items()):
            def timed(pred, _fn=fn, _name=name):
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                t = time.perf_counter()
                val = _fn(pred)
                torch.cuda.synchronize()
                stats[_name] = dict(s=time.perf_counter() - t,
                                    peak_gib=torch.cuda.max_memory_allocated() / 2**30)
                return val
            acc._fns[name] = timed
        return acc.add("clip", frames, None), stats

    def cli(names, extra_env) -> tuple[dict, list, float]:
        out = root / f"cli_{'_'.join(names)}.json"
        code = (
            "import json, sys\n"
            "from dove_tpu_torch import eval_metrics\n"
            f"eval_metrics.main({['--pred_dir', str(png_dir), '--metrics', ','.join(names), '--output', str(out)]!r})\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('cv2', 'transformers'))\n"
            "print('IMPORTED ' + json.dumps(bad))\n")
        t = time.perf_counter()
        res = subprocess.run([sys.executable, "-c", code], env={**os.environ, **extra_env},
                             capture_output=True, text=True, timeout=900)
        if res.returncode != 0:
            raise AssertionError(f"phase 21 eval_metrics failed: {res.stderr[-3000:]}")
        imported = json.loads(res.stdout.split("IMPORTED ")[-1].strip())
        summary = json.loads(out.read_text())
        if summary["count"] != 1 or summary["per_sample_names"] != ["clip"]:
            raise AssertionError(f"phase 21 eval_metrics counted {summary['count']}")
        return summary["average"], imported, time.perf_counter() - t

    raft_cudnn = _raft_with_and_without_cudnn(env["DOVE_RAFT_WEIGHTS"],
                                              frames[:PAIR_CHUNK + 1])
    try:
        vals, stats = in_process(list(NR_METRICS))
        cli_vals, imported, cli_s = cli(list(NR_METRICS), {})
        os.environ["DOVE_CLIP_WEIGHTS"] = rn50
        rn_vals, rn_stats = in_process(["clipiqa"])
        rn_cli, rn_imported, rn_cli_s = cli(["clipiqa"], {})
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    vals["clipiqa_rn50"], cli_vals["clipiqa_rn50"] = rn_vals["clipiqa"], rn_cli["clipiqa"]
    stats["clipiqa_rn50"] = rn_stats["clipiqa"]
    errs = {n: abs(cli_vals[n] - v) / max(abs(v), 1e-30) for n, v in vals.items()}
    log(f"phase 21 no-reference scores ({CLIP_FRAMES}x720x1280, phase 19's fused clip "
        f"from PNG, seeded checkpoints at the published widths, {weights_s:.1f}s to "
        f"write): {json.dumps(rounded(vals, 6))}; per metric in-process "
        f"{json.dumps({n: {'s': round(st['s'], 3), 'peak_gib': round(st['peak_gib'], 2)} for n, st in stats.items()})}; "
        f"eval_metrics CLI without --gt_dir {cli_s:.1f}s (RN50 clipiqa {rn_cli_s:.1f}s), "
        f"rel diffs {json.dumps({k: f'{v:.1e}' for k, v in errs.items()})}; the CLI's "
        f"child imported {imported + rn_imported or 'no cv2 and no transformers'}; "
        f"RAFT, {PAIR_CHUNK} 720x1280 pairs, {RAFT_CUDNN_ITERS} iterations, warm: through "
        f"cuDNN {raft_cudnn['cudnn_s']:.3f}s, through PyTorch's own convolutions "
        f"(the port's route) {raft_cudnn['native_s']:.3f}s, flows "
        f"{raft_cudnn['max_abs_diff']:.2e} px apart")
    if imported or rn_imported:
        raise AssertionError(f"phase 21: the eval CLI imported {imported + rn_imported}")
    bad = {n: e for n, e in errs.items() if not e <= NR_REL_TOL}
    if bad:
        raise AssertionError(f"phase 21 CLI and accumulator disagree: {bad}")
    if not all(math.isfinite(v) for v in vals.values()):
        raise AssertionError(f"phase 21 scores {vals}")
    if not all(0.0 < vals[n] < 1.0 for n in ("clipiqa", "clipiqa_rn50")):
        raise AssertionError(f"phase 21 clipiqa outside (0, 1): {vals}")
    return dict(scores=vals, cli=cli_vals, stats=stats, cli_s=cli_s, rn50_cli_s=rn_cli_s,
                weights_s=weights_s, raft_cudnn=raft_cudnn)


def phases_fused_and_scoring() -> tuple[dict, dict]:
    """Phase 19, then phases 20 and 21 on its clips."""
    fused = phase_fused_main_path()
    scores = phase_scoring(fused.pop("fused_out"), fused.pop("staged_out"))
    scores["nr"] = phase_nr_scoring("build/chip_smoke_eval/pred")
    return fused, scores


# ---------------------------------------------------------------------------
# Phases 22 and 23: the training data pipeline and the training entry point
# ---------------------------------------------------------------------------

class SmoothClips(RealSRDataset):
    """The stage-1 dataset with each manifest entry's frames made from a seed
    (the card decodes no video file, ROADMAP C.2): only ``read_clip`` is
    replaced."""

    def read_clip(self, path, max_frames: int) -> torch.Tensor:
        return smooth_clip(_clip_seed(path))[:max_frames]


class SmoothClipsWithImages(RealSRImageVideoDataset):
    """The stage-2 dataset: seeded clips for the video entries, the image
    entries read from their PNG files through Pillow."""

    def read_clip(self, path, max_frames: int) -> torch.Tensor:
        if str(path).lower().endswith(".png"):
            return super().read_clip(path, max_frames)
        return smooth_clip(_clip_seed(path))[:max_frames]


def _clip_seed(path) -> int:
    return int(str(path).rsplit("_", 1)[-1].split(".")[0])


def smooth_clip(seed: int, frames: int = SOURCE_FRAMES, h: int = SOURCE_H,
                w: int = SOURCE_W) -> torch.Tensor:
    """A seeded smooth clip [frames, h, w, 3] in [0, 1] on the host: a coarse
    random grid, trilinearly upsampled."""
    import torch.nn.functional as F

    gen = torch.Generator().manual_seed(seed)
    coarse = torch.rand((1, 3, 6, max(h // 40, 2), max(w // 40, 2)), generator=gen)
    clip = F.interpolate(coarse, size=(frames, h, w), mode="trilinear",
                         align_corners=False)
    return clip[0].permute(1, 2, 3, 0).contiguous()


def _write_png(array01, path) -> None:
    from PIL import Image

    u8 = (np.asarray(array01) * 255.0).clip(0, 255).astype(np.uint8)
    Image.fromarray(u8).save(path, compress_level=1)


def prepare_data_dir() -> dict:
    """build/chip_smoke_data: manifests of seeded clip entries (empty files:
    SmoothClips makes the frames), DIV2K-sized PNG images, the validation
    set (PNG folders of 9x180x320 with 9x720x1280 GT), and the degradation
    configs: the published ones where OpenCV imports, else with mpeg4's
    codec share moved to libx264 and h264 (C.2)."""
    import shutil
    from pathlib import Path

    import torch.nn.functional as F

    root = Path(DATA_DIR)
    shutil.rmtree(root, ignore_errors=True)
    (root / "clips").mkdir(parents=True)
    for i in range(DATA_CLIPS):
        (root / "clips" / f"clip_{i}.mp4").touch()
    (root / "loader.txt").write_text("".join(f"clips/clip_{i}.mp4\n"
                                             for i in range(DATA_CLIPS)))
    (root / "HQ-VSR.txt").write_text("".join(f"clips/clip_{i}.mp4\n"
                                             for i in range(RECIPE_CLIPS)))
    div2k = root / "DIV2K"
    div2k.mkdir()
    for i in range(RECIPE_CLIPS):
        _write_png(smooth_clip(100 + i, 1, *IMAGE_HW)[0], div2k / f"{i:04d}.png")
    (div2k / "DIV2K.txt").write_text("".join(f"{i:04d}.png\n"
                                             for i in range(RECIPE_CLIPS)))
    for k in range(VAL_CLIPS):
        gt = smooth_clip(200 + k, VAL_FRAMES, VAL_H * 4, VAL_W * 4)
        lq = F.interpolate(gt.permute(0, 3, 1, 2), size=(VAL_H, VAL_W), mode="area")
        lq = lq.permute(0, 2, 3, 1)
        for kind, frames in (("GT", gt), ("LQ", lq)):
            d = root / "UDM10" / kind / f"clip{k}"
            d.mkdir(parents=True)
            for t in range(VAL_FRAMES):
                _write_png(frames[t], d / f"{t:03d}.png")
    # mpeg4 round-trips through OpenCV's writer: where OpenCV is missing, its
    # codec share moves to libx264 and h264 (the MJPEG round trip)
    try:
        import cv2  # noqa: F401

        mpeg4 = True
    except ImportError:
        mpeg4 = False
    configs = {}
    for name in ("degradation.yaml", "degradation_image_video.yaml"):
        configs[name] = Path("configs", name)
        if mpeg4:
            continue
        text = configs[name].read_text()
        moved = text.replace("codec_prob: [0.3333, 0.3333, 0.3334]",
                             "codec_prob: [0.5, 0.5, 0.0]")
        if moved.count("codec_prob: [0.5, 0.5, 0.0]") != text.count("codec_prob:"):
            raise AssertionError(f"{name}: a codec_prob line is not the published one")
        configs[name] = root / name.replace(".yaml", "_no_mpeg4.yaml")
        configs[name].write_text(moved)
    return {"root": root, "configs": configs, "mpeg4": mpeg4}


class _TimedOps:
    """For the length of a ``with``: every degradation op class's ``__call__``
    adds its seconds to ``seconds`` under the class's name."""

    def __init__(self):
        from dove_tpu_torch.data import degradation as deg_mod

        self.classes = [deg_mod.RandomBlur, deg_mod.RandomResize, deg_mod.RandomNoise,
                        deg_mod.RandomJPEGCompression, deg_mod.RandomVideoCompression]
        self.seconds: dict[str, float] = {}

    def __enter__(self):
        self.saved = [cls.__call__ for cls in self.classes]
        for cls, call in zip(self.classes, self.saved):
            def timed(op, frames, rng, call=call, name=cls.__name__):
                t0 = time.perf_counter()
                out = call(op, frames, rng)
                self.seconds[name] = self.seconds.get(name, 0.0) + time.perf_counter() - t0
                return out

            cls.__call__ = timed
        return self

    def __exit__(self, *exc):
        for cls, call in zip(self.classes, self.saved):
            cls.__call__ = call


def _peak_rss_gib() -> tuple[float, float]:
    import resource

    kib = [resource.getrusage(w).ru_maxrss for w in (resource.RUSAGE_SELF,
                                                      resource.RUSAGE_CHILDREN)]
    return kib[0] / 2**20, kib[1] / 2**20


def _loader_run(dataset, workers: int, batches: int) -> tuple[list, dict]:
    """The first ``batches`` batches of a Loader of TRAIN_BATCH with
    ``workers`` processes: (the batches, items/s whole and after the first
    batch, seconds to the first batch)."""
    from dove_tpu_torch.data.loader import Loader

    loader = Loader(dataset, batch_size=TRAIN_BATCH, num_workers=workers, seed=42)
    out = []
    t0 = time.perf_counter()
    it = iter(loader)
    for _ in range(batches):
        out.append(next(it))
        if len(out) == 1:
            t_first = time.perf_counter()
    del it
    t_end = time.perf_counter()
    n = batches * TRAIN_BATCH
    rest = (n - TRAIN_BATCH) / (t_end - t_first) if batches > 1 else None
    return out, dict(items=n, items_per_s=n / (t_end - t0), after_first_per_s=rest,
                     first_batch_s=t_first - t0)


def phase_data_pipeline() -> dict:
    """Phase 22: the data pipeline at the stage-1 recipe's size (train
    resolution 25x320x640, so a 35x480x960 crop of each 40x540x960 source)."""
    import os

    from PIL import features

    data = prepare_data_dir()
    root = data["root"]
    cfg = data["configs"]["degradation.yaml"]
    ds = SmoothClips(root, root / "loader.txt", TRAIN_FRAMES, TRAIN_H, TRAIN_W, cfg,
                     seed=42)
    # the loader's first batch made in this process: items/s at 0 workers,
    # and the first item's seconds by op
    from dove_tpu_torch.data.loader import BatchPlan

    first_idx = BatchPlan(len(ds), TRAIN_BATCH, seed=42).batches()[0]
    t0 = time.perf_counter()
    with _TimedOps() as timed:
        inline = [ds[first_idx[0]]]
        item_s = time.perf_counter() - t0
    inline.append(ds[first_idx[1]])
    rates = {0: dict(items=TRAIN_BATCH, items_per_s=TRAIN_BATCH / (time.perf_counter() - t0))}
    op_s = dict(timed.seconds)
    op_s["read, crops and the final resize"] = item_s - sum(op_s.values())
    if inline[0]["lq_video"].shape != (TRAIN_FRAMES, TRAIN_H, TRAIN_W, 3):
        raise AssertionError(f"phase 22 item {inline[0]['lq_video'].shape}")
    kept = None
    for workers in sorted({LOADER_WORKERS, os.cpu_count() or LOADER_WORKERS}):
        n_batches = min(max(2, workers // TRAIN_BATCH), DATA_CLIPS // TRAIN_BATCH)
        batches, rates[workers] = _loader_run(ds, workers, n_batches)
        if not all(np.array_equal(batches[0][k][i], inline[i][k])
                   for k in ("hq_video", "lq_video") for i in range(TRAIN_BATCH)):
            raise AssertionError(f"phase 22: the first batch of {workers} workers "
                                 "differs from the in-process batch")
        if workers == LOADER_WORKERS:
            kept = batches[:2]
    rss_self, rss_children = _peak_rss_gib()

    # the stage-2 image branch on PNG files read through Pillow
    s2cfg = data["configs"]["degradation_image_video.yaml"]
    ds2 = SmoothClipsWithImages(
        root, root / "HQ-VSR.txt", S2_FRAMES, S2_H, S2_W, s2cfg,
        image_data_root=root / "DIV2K", image_manifest=root / "DIV2K" / "DIV2K.txt",
        seed=42)
    t0 = time.perf_counter()
    item2 = ds2[0]
    s2_item_s = time.perf_counter() - t0
    if item2["lq_image"].shape != (1, S2_H, S2_W, 3):
        raise AssertionError(f"phase 22 image pair {item2['lq_image'].shape}")
    need = TRAIN_BATCH / STEP_S1_S
    keeps_up = rates[LOADER_WORKERS]["items_per_s"] >= need
    jpeg = f"libjpeg {features.version('jpg')} (turbo: {features.check_feature('libjpeg_turbo')})"
    log(f"phase 22 data pipeline (stage-1 recipe: {TRAIN_FRAMES}x{TRAIN_H}x{TRAIN_W}, "
        f"crops of {ds.inter_frames}x{ds.inter_height}x{ds.inter_width} from "
        f"{SOURCE_FRAMES}x{SOURCE_H}x{SOURCE_W} seeded "
        f"clips, configs/degradation.yaml{'' if data['mpeg4'] else ', mpeg4 moved to libx264/h264 (no OpenCV)'}): "
        f"one item {item_s:.2f}s in this process, by op "
        f"{json.dumps({k: round(v, 3) for k, v in op_s.items()})}; loader "
        f"{json.dumps({w: {k: (round(v, 3) if isinstance(v, float) else v) for k, v in r.items()} for w, r in rates.items()})} "
        f"(workers: items/s over the run and after the first batch); the first batch of "
        f"{LOADER_WORKERS} workers equal to the in-process one; the stage-1 step needs "
        f"{need:.3f} items/s ({TRAIN_BATCH} per {STEP_S1_S} s, PERF.md section 5): "
        f"{'kept up' if keeps_up else 'NOT kept up'} at {LOADER_WORKERS} workers; "
        f"stage-2 item (a 2x320x640 pair and an image pair from a "
        f"{IMAGE_HW[0]}x{IMAGE_HW[1]} PNG) {s2_item_s:.2f}s; peak RSS this process "
        f"{rss_self:.2f} GiB, largest worker {rss_children:.2f} GiB; Pillow {jpeg}; "
        f"{os.cpu_count()} host cores")
    return dict(data, batches=kept, rates=rates, op_s=op_s, item_s=item_s,
                s2_item_s=s2_item_s, keeps_up=keeps_up)


def script_argv(name: str, env: dict) -> list[str]:
    """The argv that scripts/<name> hands scripts/train.py, as bash expands
    it with ``env``."""
    import os
    from pathlib import Path

    text = Path("scripts", name).read_text().replace("python scripts/train.py",
                                                     "printf '%s\\n'")
    out = subprocess.run(["bash", "-c", text], capture_output=True, text=True,
                         check=True, timeout=60, env={**os.environ, **env})
    return out.stdout.splitlines()


class _TrainProbe:
    """Wraps Trainer.train_step and validate, and DovePipeline's DiT pass,
    for the length of a ``with``: per step its wall (after a synchronise)
    and the attention launches, per validation its wall, peak memory, K1
    launches and DiT passes."""

    def __init__(self):
        from dove_tpu_torch.pipeline import DovePipeline
        from dove_tpu_torch.train import trainer as tr_mod

        self.targets = [(tr_mod.Trainer, "train_step"), (tr_mod.Trainer, "validate"),
                        (DovePipeline, "_denoise")]
        self.steps: list[dict] = []
        self.validations: list[dict] = []
        self.passes = 0

    def __enter__(self):
        self.saved = [getattr(cls, name) for cls, name in self.targets]
        train_step, validate, denoise = self.saved
        probe = self
        counters = _k3_counters()

        def timed_step(tr, batch):
            before = {n: c.count for n, c in counters.items()}
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = train_step(tr, batch)
            torch.cuda.synchronize()
            probe.steps.append(dict(
                wall_s=time.perf_counter() - t0,
                launches={n: c.count - before[n] for n, c in counters.items()}))
            return out

        def timed_validate(tr, step):
            k1, passes = counters["k1"].count, probe.passes
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            out = validate(tr, step)
            torch.cuda.synchronize()
            probe.validations.append(dict(
                step=step, wall_s=time.perf_counter() - t0, summary=out,
                peak_bytes=torch.cuda.max_memory_allocated(),
                k1=counters["k1"].count - k1, passes=probe.passes - passes))
            return out

        def counted_denoise(pipe, *a, **kw):
            probe.passes += 1
            return denoise(pipe, *a, **kw)

        for (cls, name), fn in zip(self.targets, (timed_step, timed_validate,
                                                   counted_denoise)):
            setattr(cls, name, fn)
        return self

    def __exit__(self, *exc):
        for (cls, name), fn in zip(self.targets, self.saved):
            setattr(cls, name, fn)


def _step_losses(out_dir) -> dict[int, float]:
    from pathlib import Path

    recs = [json.loads(x) for x in (Path(out_dir) / "train_log.jsonl")
            .read_text().splitlines()]
    return {r["step"]: r["loss"] for r in recs if "loss" in r}


def _run_main(argv: list[str]) -> tuple:
    """dove_tpu_torch.train's main(argv) with the datasets' read_clip on
    seeded clips; -> (the trainer's numbers, the probe)."""
    from dove_tpu_torch.data import datasets as ds_mod
    from dove_tpu_torch.train.__main__ import main as train_main

    saved = ds_mod.RealSRDataset, ds_mod.RealSRImageVideoDataset
    ds_mod.RealSRDataset, ds_mod.RealSRImageVideoDataset = SmoothClips, SmoothClipsWithImages
    torch.cuda.reset_peak_memory_stats()
    try:
        with _TrainProbe() as probe:
            t0 = time.perf_counter()
            tr = train_main(argv)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    finally:
        ds_mod.RealSRDataset, ds_mod.RealSRImageVideoDataset = saved
    info = dict(wall_s=wall, data_wait_s=list(tr.data_wait_s),
                layers=tr.config.dit.num_layers, peak_bytes=torch.cuda.max_memory_allocated())
    del tr
    torch.cuda.empty_cache()
    return info, probe


def _fit_kernel_vs_plain(argv: list[str], batches: list) -> dict:
    """The same 2 steps on phase 22's first two batches at 2 layers, through
    the kernels and through the plain attention."""
    import dataclasses

    from dove_tpu_torch import cogvideox1_5_5b
    from dove_tpu_torch.train.args import Args
    from dove_tpu_torch.train.trainer import DOVES1Trainer

    base = cogvideox1_5_5b()
    cfg = dataclasses.replace(base, dit=dataclasses.replace(base.dit, num_layers=2))
    parser = Args.parser()
    parser.add_argument("--device")
    args = Args.from_namespace(parser.parse_args(argv))
    runs = {}
    for backend in ("flash", "plain"):
        tr = DOVES1Trainer(args, pipeline_config=cfg, device="cuda")
        tr.load_components()
        tr.prepare_optimizer(2)
        tr.attention_backend = backend
        counters = _k3_counters()
        before = {n: c.count for n, c in counters.items()}
        losses = []
        for batch in batches:
            loss, _, _ = tr.train_step(tr.device_batch(batch))
            tr.global_step += 1
            losses.append(float(loss))
        runs[backend] = (losses, {n: c.count - before[n] for n, c in counters.items()})
        del tr
    torch.cuda.empty_cache()
    (k_loss, k_counts), (p_loss, p_counts) = runs["flash"], runs["plain"]
    rel = [abs(a - b) / abs(b) for a, b in zip(k_loss, p_loss)]
    want = {"k1": 0, "k1_lse": 8, "k2": 0, "k3a": 4, "k3b": 4}
    if k_counts != want or any(p_counts.values()) or not max(rel) <= TRAIN_LOSS_REL_TOL:
        raise AssertionError(f"phase 23 2-layer fit: losses {k_loss} vs {p_loss}, "
                             f"launches {k_counts} / {p_counts}")
    return dict(kernel=k_loss, plain=p_loss, rel=rel, launches=k_counts)


def phase_train_entry_point(data: dict) -> dict:
    """Phase 23: python -m dove_tpu_torch.train's main at 2 layers with
    scripts/train_s1.sh's flags (4 steps, checkpoints every 2, validation
    every 2), a resume from checkpoint-2, the is_latent route, and
    scripts/train_s2.sh's flags for 2 steps; then the same 2 steps through
    the kernels and through the plain attention. The phase ran at 42 layers
    until the run grew past its time limit: its time goes to the
    host's items and the VAE, and phases 11, 17 and 26 run the recipes' steps
    at 42 layers."""
    with _two_layer_presets():
        return _train_entry_point(data)


def _train_entry_point(data: dict) -> dict:
    import shutil
    from pathlib import Path

    from dove_tpu_torch.train import trainer as tr_mod

    root = Path(DATA_DIR)
    out = Path("build/chip_smoke_fit")
    shutil.rmtree(out, ignore_errors=True)
    env = {"MODEL_PATH": "build/no-checkpoint", "DATA_ROOT": str(root),
           "IMAGE_ROOT": str(root / "DIV2K"), "OUTPUT_DIR": str(out / "s1")}
    cfgs = {n: str(p) for n, p in data["configs"].items()}
    # items made in this process: one worker process takes ~40 s for a
    # stage-1 item (phase 22), far longer than these short runs' steps
    common = ["--num_workers", "0", "--device", "cuda"]
    s1 = script_argv("train_s1.sh", env) + common + [
        "--degradation_config", cfgs["degradation.yaml"], "--train_steps", "4",
        "--checkpointing_steps", "2", "--do_validation", "true",
        "--validation_steps", "2", "--eval_metric_list", "psnr,ssim"]
    info, probe = _run_main(s1)
    layers = info["layers"]
    losses = _step_losses(out / "s1")
    want = {"k1": 0, "k1_lse": 2 * layers, "k2": 0, "k3a": layers, "k3b": layers}
    if [s["launches"] for s in probe.steps] != [want] * 4 or sorted(losses) != [1, 2, 3, 4]:
        raise AssertionError(f"phase 23 stage 1: steps {probe.steps}, losses {losses}")
    if not all(math.isfinite(x) for x in losses.values()):
        raise AssertionError(f"phase 23 stage 1 losses {losses}")
    vals = probe.validations
    if len(vals) != 2 or any(v["k1"] != layers * v["passes"] or v["passes"] < VAL_CLIPS
                             or set(v["summary"]) != {"psnr", "ssim"} for v in vals):
        raise AssertionError(f"phase 23 validations {vals}")
    # the SR clips: mp4s where OpenCV imports, else PNG folders
    kind = "mp4" if data["mpeg4"] else "png"
    recs = [json.loads(x) for x in (out / "s1" / "train_log.jsonl").read_text().splitlines()]
    artifact = "clip{}.mp4" if kind == "mp4" else "clip{}/000.png"
    if [r.get("artifact") for r in recs if "validation" in r] != [kind, kind] or not all(
            (out / "s1" / "validation_res" / f"Step-{s}" / artifact.format(k)).exists()
            for s in (2, 4) for k in range(VAL_CLIPS)):
        raise AssertionError(f"phase 23: the validation records or {kind} artifacts")
    if sorted(p.name for p in (out / "s1").glob("checkpoint-*")) != ["checkpoint-2",
                                                                    "checkpoint-4"]:
        raise AssertionError("phase 23: checkpoints")

    # resume from checkpoint-2: steps 3 and 4 again
    resumed = s1 + ["--output_dir", str(out / "resumed"), "--do_validation", "false",
                    "--resume_from_checkpoint", str(out / "s1" / "checkpoint-2")]
    info_r, probe_r = _run_main(resumed)
    again = _step_losses(out / "resumed")
    resume_rel = {s: abs(again[s] - losses[s]) / abs(losses[s]) for s in (3, 4)}
    if sorted(again) != [3, 4] or not max(resume_rel.values()) <= RESUME_LOSS_REL_TOL:
        raise AssertionError(f"phase 23 resume: {again} against {losses}")

    # the is_latent route: the cache filled in this process, then read by workers
    latent = s1 + ["--output_dir", str(out / "latent"), "--is_latent", "true",
                   "--train_steps", "2", "--do_validation", "false"]
    info_l, probe_l = _run_main(latent)
    cache = root / "cache" / "video_latent"
    files = sorted(str(p.relative_to(cache)) for p in cache.rglob("*.safetensors"))
    want_files = sorted(f"{kind}/dove-s1/{TRAIN_FRAMES}x{TRAIN_H}x{TRAIN_W}/clip_{i}"
                        ".safetensors" for kind in ("hq", "lq") for i in range(RECIPE_CLIPS))
    if files != want_files or len(_step_losses(out / "latent")) != 2 or any(
            st["launches"] != want for st in probe_l.steps):
        raise AssertionError(f"phase 23 is_latent: cache {files}")
    lat_steps = [s["wall_s"] for s in probe_l.steps]
    lat_losses = _step_losses(out / "latent")

    # stage 2: scripts/train_s2.sh's flags; its end-of-run checkpoint (the
    # whole DiT and its AdamW moments, ~60 GB) is not written
    env2 = {**env, "OUTPUT_DIR": str(out / "s2")}
    s2 = script_argv("train_s2.sh", env2) + common + [
        "--degradation_config", cfgs["degradation_image_video.yaml"],
        "--train_steps", "2", "--allow_random_perceptual", "true"]
    saves = []
    save = tr_mod.Trainer.save
    tr_mod.Trainer.save = lambda tr, step: saves.append(step)
    try:
        info_2, probe_2 = _run_main(s2)
    finally:
        tr_mod.Trainer.save = save
    s2_losses = _step_losses(out / "s2")
    image_steps = [bool(np.random.default_rng((42, s)).uniform() < 0.8) for s in range(2)]
    if sorted(s2_losses) != [1, 2] or saves != [2] or any(
            st["launches"] != want for st in probe_2.steps):
        raise AssertionError(f"phase 23 stage 2: {s2_losses}, saves {saves}")

    two = _fit_kernel_vs_plain(s1 + ["--output_dir", str(out / "two")], data["batches"])
    shutil.rmtree(out, ignore_errors=True)

    steps = [s["wall_s"] for s in probe.steps]
    waits = info["data_wait_s"]
    idle = sum(waits) / (sum(waits) + sum(steps))
    log(f"phase 23 training entry point (python -m dove_tpu_torch.train's main with "
        f"scripts/train_s1.sh's flags, {layers} layers, items made in this process "
        f"(--num_workers 0), {RECIPE_CLIPS} seeded clips, validation on {VAL_CLIPS} PNG clips "
        f"{VAL_FRAMES}x{VAL_H}x{VAL_W} -> x4 against GT): run {info['wall_s']:.1f}s; "
        f"step walls {[round(x, 3) for x in steps]} s, losses "
        f"{ {k: round(v, 6) for k, v in losses.items()} }; loader wait per step "
        f"{[round(x, 3) for x in waits]} s (the device idles at least "
        f"{100 * idle:.1f}% of the steps' time waiting for data); launches per step "
        f"{want}; validations {[dict(step=v['step'], wall_s=round(v['wall_s'], 2), peak_gib=round(v['peak_bytes'] / 2**30, 2), k1=v['k1'], passes=v['passes'], **{k: round(x, 4) for k, x in v['summary'].items()}) for v in vals]} "
        f"(artifact: {kind}). Resumed "
        f"from checkpoint-2: steps 3, 4 losses {again} (relative {resume_rel}, bar "
        f"{RESUME_LOSS_REL_TOL}) in {info_r['wall_s']:.1f}s. is_latent: "
        f"{len(files)} cache files in the reference layout, run {info_l['wall_s']:.1f}s "
        f"(the encode pre-pass included), steps {[round(x, 3) for x in lat_steps]} s, "
        f"losses {lat_losses}. Stage 2 "
        f"(train_s2.sh: SFT, image_ratio 0.8, DISTS on random VGG16): steps "
        f"{[round(s['wall_s'], 3) for s in probe_2.steps]} s (image step: "
        f"{image_steps}), losses {s2_losses}, launches "
        f"{[s['launches'] for s in probe_2.steps]}, run {info_2['wall_s']:.1f}s, peak "
        f"{info_2['peak_bytes'] / 2**30:.2f} GiB. 2 layers, kernels vs plain on "
        f"phase 22's first two batches: losses {two['kernel']} vs {two['plain']} "
        f"(relative {[f'{x:.1e}' for x in two['rel']]}, bar {TRAIN_LOSS_REL_TOL}), "
        f"launches {two['launches']}")
    return dict(layers=layers, steps=probe.steps, validations=vals,
                s2_steps=probe_2.steps, latent_steps=probe_l.steps,
                resume_rel=resume_rel, data_wait_s=waits, idle_share=idle, two=two)


# ---------------------------------------------------------------------------
# Phase 24: the CLI and a dataset on video files (ROADMAP C.2)
# ---------------------------------------------------------------------------

def _two_layer_presets(preset: str = "cogvideox1.5-5b"):
    """For the length of a ``with``: a preset (the 5B, or "cogvideox-2b") as
    the CLI's loader and the trainer read it, cut to 2 DiT layers (the depth
    of phase 18)."""
    import contextlib
    import dataclasses

    from dove_tpu_torch import config as cfg_mod
    from dove_tpu_torch.train import trainer as tr_mod

    attr = {"cogvideox1.5-5b": "cogvideox1_5_5b", "cogvideox-2b": "cogvideox_2b"}[preset]
    full = getattr(cfg_mod, attr)

    def two():
        base = full()
        return dataclasses.replace(base, dit=dataclasses.replace(base.dit, num_layers=2))

    @contextlib.contextmanager
    def patched():
        saved = tr_mod.PRESETS[preset]
        setattr(cfg_mod, attr, two)
        tr_mod.PRESETS[preset] = two
        try:
            yield
        finally:
            setattr(cfg_mod, attr, full)
            tr_mod.PRESETS[preset] = saved

    return patched()


def phase_video_files() -> dict:
    """Phase 24 (ROADMAP C.2): video files in and out on the card. Two seeded
    LQ clips written as mp4 (mp4v) through io/video.save_video, 33x180x320
    and 9x96x160; ``python -m dove_tpu_torch.inference``'s main over them with
    --is_vae_st at 2 layers (mp4 out, and once more with --png_save, the
    lossless dump), each output decoded by read_video_frames; the same clips
    through load_pipeline + process_frames in this process; then a
    RealSRDataset over mp4 clips with configs/degradation.yaml, whose mpeg4
    branch round-trips through OpenCV."""
    import shutil
    from pathlib import Path

    from dove_tpu_torch.data import degradation as deg_mod
    from dove_tpu_torch.inference import build_parser, load_pipeline, main as cli_main
    from dove_tpu_torch.inference import process_kwargs
    from dove_tpu_torch.io import video as video_io
    from dove_tpu_torch.ops import flash_attention as fa

    try:
        import cv2
    except ImportError as e:
        raise AssertionError(f"phase 24: OpenCV does not import ({e}): the card "
                             "cannot read or write video files (ROADMAP C.2)") from e
    root = Path(VIDEO_DIR)
    shutil.rmtree(root, ignore_errors=True)
    (root / "in").mkdir(parents=True)
    written = {}
    for i, (f, h, w) in enumerate(VIDEO_CLIPS):
        clip = smooth_clip(300 + i, f, h, w).numpy()
        path = video_io.save_video(clip, root / "in" / f"clip{i}.mp4", fps=16,
                                   pixel_format="rgb")
        written[path.name] = (f, h, w)
    decoded_in = {name: video_io.read_video_frames(root / "in" / name) for name in written}
    for name, (f, h, w) in written.items():
        if decoded_in[name].shape != (f, h, w, 3):
            raise AssertionError(f"phase 24: {name} reads back as {decoded_in[name].shape}")
    runs = {}
    with _two_layer_presets():
        for kind, extra in (("mp4", []), ("png", ["--png_save"])):
            argv = ["--input_dir", str(root / "in"), "--output_path", str(root / kind),
                    "--is_vae_st", "--seed", "0"] + extra
            fa.launches.reset()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            cli_main(argv)
            torch.cuda.synchronize()
            runs[kind] = dict(wall_s=time.perf_counter() - t0, k1=fa.launches.count,
                              argv=argv)
        args = build_parser().parse_args(runs["mp4"]["argv"])
        pipe = load_pipeline(args)
        layers = pipe.config.dit.num_layers
        checks = {}
        for name, (f, h, w) in written.items():
            out_i420 = pipe.process_frames(decoded_in[name], **process_kwargs(args))
            pipe.output_i420 = False
            out_rgb = pipe.process_frames(decoded_in[name], **process_kwargs(args))
            pipe.output_i420 = True
            want = (f, 4 * h, 4 * w, 3)
            mp4 = video_io.read_video_frames(root / "mp4" / name)
            png = video_io.read_image_folder(root / "png" / Path(name).stem)
            if mp4.shape != want or png.shape != want:
                raise AssertionError(f"phase 24 {name}: mp4 {mp4.shape}, png {png.shape}, "
                                     f"want {want}")
            ref = video_io.i420_to_rgb(out_i420)
            codec_db = psnr_u8(np.round(mp4 * 255).astype(np.uint8), ref)
            png_u8 = np.round(png * 255).astype(np.uint8)
            png_db = psnr_u8(png_u8, out_rgb)
            checks[name] = dict(mp4_vs_in_process_db=codec_db, png_vs_in_process_db=png_db,
                                png_identical=bool(np.array_equal(png_u8, out_rgb)),
                                shape=list(want))
            if not codec_db >= VIDEO_CODEC_PSNR_DB or not png_db >= PSNR_BAR_DB:
                raise AssertionError(f"phase 24 {name}: {checks[name]}")
        del pipe
    torch.cuda.empty_cache()
    outputs = {kind: sorted(p.name for p in (root / kind).iterdir()) for kind in runs}
    if outputs["mp4"] != sorted(written) or outputs["png"] != sorted(
            Path(n).stem for n in written):
        raise AssertionError(f"phase 24 outputs {outputs}")
    for kind, run in runs.items():
        if run["k1"] != layers * len(written):
            raise AssertionError(f"phase 24 {kind} run: K1 {run['k1']}, want "
                                 f"{layers} x {len(written)}")

    # a dataset over mp4 clips: read through OpenCV, mpeg4 through its writer
    data = root / "data"
    (data / "clips").mkdir(parents=True)
    for i in range(DATASET_CLIPS):
        video_io.save_video(smooth_clip(400 + i, *DATASET_SOURCE).numpy(),
                            data / "clips" / f"clip_{i}.mp4", fps=25, pixel_format="rgb")
    (data / "list.txt").write_text("".join(f"clips/clip_{i}.mp4\n"
                                           for i in range(DATASET_CLIPS)))
    calls = {"mpeg4": 0}
    saved = deg_mod.RandomVideoCompression._cv2_roundtrip

    def counted(op, frames, bitrate):
        calls["mpeg4"] += 1
        return saved(op, frames, bitrate)

    deg_mod.RandomVideoCompression._cv2_roundtrip = counted
    items, t0 = [], time.perf_counter()
    try:
        for seed in range(8):  # the first seed whose two items draw mpeg4
            calls["mpeg4"] = 0
            ds = RealSRDataset(data_root=data, video_manifest=data / "list.txt",
                               max_num_frames=DATASET_RES[0], height=DATASET_RES[1],
                               width=DATASET_RES[2],
                               degradation_config="configs/degradation.yaml", seed=seed)
            items = [ds[0], ds[1]]
            if calls["mpeg4"]:
                break
    finally:
        deg_mod.RandomVideoCompression._cv2_roundtrip = saved
    item_s = (time.perf_counter() - t0) / max(2 * (seed + 1), 1)
    f, h, w = DATASET_RES
    for it in items:
        for key, shape in (("hq_video", (f, h, w, 3)), ("lq_video", (f, h, w, 3))):
            arr = np.asarray(it[key])
            if arr.shape != shape or not np.isfinite(arr).all() or not arr.std() > 0:
                raise AssertionError(f"phase 24 dataset item {key}: {arr.shape}")
    if not calls["mpeg4"]:
        raise AssertionError("phase 24: no item drew the mpeg4 codec in 8 seeds")
    backend = deg_mod.compression_backend()
    # phase 32 runs the CLI again on these clips with a prompt, beside these
    # PNG outputs (the empty prompt's)
    for sub in ("mp4", "data"):
        shutil.rmtree(root / sub, ignore_errors=True)
    log(f"phase 24 video files (ROADMAP C.2; OpenCV {cv2.__version__}): "
        f"{len(written)} mp4 clips {list(written.values())} -> python -m "
        f"dove_tpu_torch.inference --is_vae_st ({layers} layers): outputs "
        f"{outputs['mp4']} in {runs['mp4']['wall_s']:.1f}s, K1 {runs['mp4']['k1']} "
        f"(= {layers} x {len(written)}); --png_save {runs['png']['wall_s']:.1f}s; "
        f"against process_frames on the decoded input: "
        f"{json.dumps({n: {k: (round(v, 2) if isinstance(v, float) else v) for k, v in c.items()} for n, c in checks.items()})} "
        f"(bars: mp4 {VIDEO_CODEC_PSNR_DB} dB, png {PSNR_BAR_DB} dB); RealSRDataset "
        f"over {DATASET_CLIPS} mp4 clips of {DATASET_SOURCE} with "
        f"configs/degradation.yaml at {DATASET_RES} (seed {seed}): 2 items, "
        f"{calls['mpeg4']} mpeg4 round trips through OpenCV, ~{item_s:.2f}s an "
        f"item; video_compression_backend {backend!r}")
    return dict(runs={k: dict(wall_s=v["wall_s"], k1=v["k1"]) for k, v in runs.items()},
                checks=checks, mpeg4_calls=calls["mpeg4"], backend=backend, layers=layers)


# ---------------------------------------------------------------------------
# Phase 25: the int8 drift report and weight floor at 42 layers (ROADMAP A.4)
# ---------------------------------------------------------------------------

def _stage_conv_launches(pipe, frames: int, h: int, w: int) -> dict:
    """K4 and quantizer launches of run_stages' enc_all and dec_all on an
    unpadded LQ clip under the pipeline's window plan."""
    from dove_tpu_torch.models.vae import _frame_chunks
    from dove_tpu_torch.pipeline import plan_axis

    cfg = pipe.config
    lat_h = h * cfg.upscale // cfg.vae.spatial_scale
    lat_w = w * cfg.upscale // cfg.vae.spatial_scale
    blend, enc_max, dec_max = pipe._window_budget()

    def windows(budget):
        return plan_axis(lat_h, blend, budget[0])[2] * plan_axis(lat_w, blend, budget[1])[2]

    enc = windows(enc_max) * len(_frame_chunks(frames, cfg.vae.sample_frames_batch_size))
    dec = windows(dec_max) * len(_frame_chunks(cfg.vae.latent_frames(frames),
                                               cfg.vae.latent_frames_batch_size))
    return _conv_launches(pipe, enc, dec)


def _drift_run(family: str, mode: str | None, attention=None, calib=None,
               exclude=()) -> tuple:
    """One run of the drift report at 42 layers: build (weights from their
    seeds), run_stages on the fixture, launches counted where they happen."""
    import gc

    from dove_tpu_torch import int8_drift_report as drift

    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    pipe = drift.build_pipe("cogvideox1.5-5b", mode, weights=family, attention=attention,
                            vae_calib=calib, vae_exclude=exclude, device="cuda")
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    counters = _conv_counters()
    for c in counters.values():
        c.reset()
    torch.cuda.reset_peak_memory_stats()
    stages = drift.run_stages(pipe, *DRIFT_FIXTURE)
    peak = torch.cuda.max_memory_allocated()
    counts = {n: c.count for n, c in counters.items()}
    layers = pipe.config.dit.num_layers
    want = dict(k1=0, k2=0, k4=0, k4_kt1=0, k5=0, quantize=0)
    want["k2" if pipe.attention_backend == "flash-qk8" else "k1"] = layers
    if mode in ("int8", "int8-dit-dec"):
        want.update(_stage_conv_launches(pipe, *DRIFT_FIXTURE))
    if counts != want or (mode in ("int8", "int8-dit-dec") and not counts["k4"] > 0):
        raise AssertionError(f"phase 25 {family} {mode} {attention}: launches {counts}, "
                             f"want {want}")
    info = dict(seconds=float(stages["seconds"]), peak_gib=peak / 2**30, build_s=build_s,
                launches=counts, attention=pipe.attention_backend)
    return pipe, stages, info


def phase_int8_drift(card: str) -> dict:
    """Phase 25 (ROADMAP A.4): dove_tpu_torch.int8_drift_report at 42 layers
    (CogVideoX1.5-5B widths, bf16) on its 33x180x320 fixture, for both weight
    families: bf16 with its calibration; int8w; int8-dit; int8-dit with bf16
    attention (K1); int8-dit-dec --exclude lowres and int8 with that
    calibration; each against bf16 (per-stage rel_err, Y-PSNR of the I420
    output) beside the JAX frontier's number; and the weight floor of the
    decoder under the serving quantizer."""
    import gc

    from dove_tpu_torch import int8_drift_report as drift
    from dove_tpu_torch.int8_weight_floor import weight_floor

    fixture = list(DRIFT_FIXTURE)
    result = {}
    for family in ("gaussian", "outlier"):
        pipe, ref, info = _drift_run(family, None)
        t0 = time.perf_counter()
        calib = drift.calibrate_pipe(pipe, ref["x0"], *DRIFT_FIXTURE)
        floor = weight_floor(pipe.vae, calib, family)
        # every quantizable conv by its local int8 error under the
        # equalized quantizer (the script's --calib_out --attribution)
        ranking = drift.attribution_ranking(pipe, ref["x0"], *DRIFT_FIXTURE, calib)
        top10 = [[name, round(err, 6)] for name, err in ranking[:10]]
        calib_s = time.perf_counter() - t0
        floor_summary = {k: floor[k] for k in ("mean_weight_rel_err", "median_weight_rel_err",
                                               "mean_output_rel_err", "median_output_rel_err")}
        log(f"phase 25 drift {family} bf16 (42 layers, fixture {fixture}): "
            f"{info['seconds']:.2f}s, peak {info['peak_gib']:.2f} GiB, build "
            f"{info['build_s']:.1f}s, launches {info['launches']}; calib "
            f"{len(calib)} entries, the weight floor of {len(floor['per_conv'])} "
            f"decoder convs and the attribution of {len(ranking)} convs in "
            f"{calib_s:.1f}s: floor {json.dumps(floor_summary)}, attribution top 10 "
            f"{json.dumps(top10)} on {card}")
        del pipe
        rows = {"bf16": dict(info, floor=floor_summary, attribution_top10=top10)}
        calib_t = {k: torch.from_numpy(v) for k, v in calib.items()}
        for label, mode, attention, use_calib, exclude in DRIFT_MODES:
            pipe, stages, info = _drift_run(family, mode, attention,
                                            calib_t if use_calib else None, exclude)
            report = drift.drift_report(
                stages, ref, preset="cogvideox1.5-5b", mode=mode, weights=family,
                attention_backend=pipe.attention_backend, fixture=fixture,
                equalized=use_calib, exclude=exclude)
            del pipe, stages
            frontier = FRONTIER_DB.get(label, {}).get(family)
            psnr = report["end_to_end"]["psnr_y_vs_bf16_db"]
            rows[label] = dict(info, rel_err=report["rel_err"], psnr_y_db=psnr,
                               psnr_i420_db=report["end_to_end"]["psnr_i420_packed_db"],
                               max_abs_u8=report["end_to_end"]["max_abs_u8"],
                               frontier_db=frontier)
            log(f"phase 25 drift {family} {label}: rel_err "
                f"{json.dumps({k: float(f'{v:.4e}') for k, v in report['rel_err'].items()})}, "
                f"Y-PSNR vs bf16 {psnr:.2f} dB (JAX frontier "
                f"{'-' if frontier is None else frontier} dB), I420 "
                f"{report['end_to_end']['psnr_i420_packed_db']:.2f} dB, max |du8| "
                f"{report['end_to_end']['max_abs_u8']}; {info['seconds']:.2f}s, peak "
                f"{info['peak_gib']:.2f} GiB, build {info['build_s']:.1f}s, launches "
                f"{info['launches']} on {card}")
            if label in DRIFT_BAR_MODES and not psnr >= DRIFT_BAR_DB:
                raise AssertionError(f"phase 25 {family} {label}: {psnr:.2f} dB below "
                                     f"the frontier's {DRIFT_BAR_DB} dB bar")
        result[family] = rows
        del calib, calib_t
        gc.collect()
        torch.cuda.empty_cache()
    return result


# ---------------------------------------------------------------------------
# Phase 26: the optimizers, gradient accumulation and trackers (ROADMAP A.8)
# ---------------------------------------------------------------------------

def phase_optimizers(data: dict) -> dict:
    """Phase 26 (ROADMAP A.8): one scripts/train_s2.sh SFT step at 42 layers
    (phase 17's trainer) with each of adamw, adamw-8bit, adamw-4bit, came and
    prodigy, after one unmeasured step each; the learning rate without the
    script's warmup, whose first rate of 0 would leave the weights where they
    are (and Prodigy's estimate 0 / 0, as in optax). Then python -m
    dove_tpu_torch.train's main at 2 layers (stage 1, phase 22's clips at
    OPT_ACCUM_RES) with --gradient_accumulation_steps 2 --report_to all
    --checkpointing_steps 3 for 4 micro-steps, and a resume from checkpoint-3
    that must repeat step 4 exactly."""
    import gc
    import shutil
    from pathlib import Path

    from dove_tpu_torch import cogvideox1_5_5b

    tr = _s2_trainer(cogvideox1_5_5b(), seed=0)
    tr.args.lr_warmup_steps = 0
    layers = tr.config.dit.num_layers
    clip, image = s2_pairs(seed=26)
    batch = tr.device_batch({**clip, "hq_image": image["hq_video"],
                             "lq_image": image["lq_video"]})
    counters = _k3_counters()
    want = {"k1": 0, "k1_lse": 2 * layers, "k2": 0, "k3a": layers, "k3b": layers}
    rows = {}
    for name in OPT_NAMES:
        tr.optimizer = None
        gc.collect()
        torch.cuda.empty_cache()
        tr.args.optimizer = name
        tr.prepare_optimizer(2)
        tr.global_step = 0
        torch.cuda.reset_peak_memory_stats()
        tr.train_step(batch)  # unmeasured: the state's first touch
        tr.global_step += 1
        before = {n: c.count for n, c in counters.items()}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss, aux, gnorm = tr.train_step(batch)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        tr.global_step += 1
        launches = {n: c.count - before[n] for n, c in counters.items()}
        finite = all(bool(torch.isfinite(p).all()) for p in tr.trainable_tensors())
        rows[name] = dict(step_s=wall, split_s=dict(tr.step_times),
                          peak_gib=torch.cuda.max_memory_allocated() / 2**30,
                          state_gib=tr.optimizer.state_bytes() / 2**30,
                          loss=float(loss), grad_norm=float(gnorm), launches=launches,
                          weights_finite=finite, kind="image" if tr.image_step(1) else "video")
        log(f"  {name}: step {wall:.3f}s, split "
            f"{json.dumps({k: round(v, 3) for k, v in tr.step_times.items()})}, peak "
            f"{rows[name]['peak_gib']:.2f} GiB, state {rows[name]['state_gib']:.2f} GiB, "
            f"loss {float(loss):.6f}, grad_norm {float(gnorm):.4e}, launches {launches}, "
            f"weights finite {finite}")
        if launches != want or not math.isfinite(float(loss)) or not finite:
            raise AssertionError(f"phase 26 {name}: {rows[name]}")
    n_params = sum(p.numel() for p in tr.trainable_tensors())
    tr.optimizer = None
    del tr, batch
    gc.collect()
    torch.cuda.empty_cache()

    # gradient accumulation and the trackers through the entry point: three
    # clips at batch 1 make an epoch of 3 micro-steps, so checkpoint-3 ends
    # an epoch and its resume sees step 4's batch (no run skips batches)
    out = Path("build/chip_smoke_accum")
    shutil.rmtree(out, ignore_errors=True)
    manifest = Path(data["root"]) / "accum.txt"
    manifest.write_text("".join(f"clips/clip_{i}.mp4\n" for i in range(3)))
    env = {"MODEL_PATH": "build/no-checkpoint", "DATA_ROOT": str(data["root"]),
           "IMAGE_ROOT": str(data["root"] / "DIV2K"), "OUTPUT_DIR": str(out / "straight")}
    res = "x".join(str(x) for x in OPT_ACCUM_RES)
    argv = script_argv("train_s1.sh", env) + [
        "--num_workers", "0", "--device", "cuda",
        "--degradation_config", str(data["configs"]["degradation.yaml"]),
        "--video_column", str(manifest), "--batch_size", "1",
        "--train_resolution", res, "--train_steps", "4", "--checkpointing_steps", "3",
        "--gradient_accumulation_steps", "2", "--report_to", "all"]
    with _two_layer_presets():
        info, probe = _run_main(argv)
        straight = _step_losses(out / "straight")
        resumed = argv + ["--output_dir", str(out / "resumed"),
                          "--resume_from_checkpoint", str(out / "straight" / "checkpoint-3")]
        info_r, probe_r = _run_main(resumed)
    again = _step_losses(out / "resumed")
    state = {k: torch.load(out / k / "checkpoint-4" / "state.pt", map_location="cpu",
                           weights_only=True) for k in ("straight", "resumed")}
    ckpt3 = torch.load(out / "straight" / "checkpoint-3" / "state.pt", map_location="cpu",
                       weights_only=True)

    def same(a, b) -> bool:
        if isinstance(a, dict):
            return set(a) == set(b) and all(same(a[k], b[k]) for k in a)
        if isinstance(a, (list, tuple)):
            return len(a) == len(b) and all(same(x, y) for x, y in zip(a, b))
        if isinstance(a, torch.Tensor):
            return torch.equal(a, b)
        return a == b

    exact = same(state["straight"], state["resumed"])
    runs = list((out / "straight" / "wandb").glob("offline-run-*"))
    files = sorted(str(p.relative_to(runs[0] / "files")) for p in
                   (runs[0] / "files").rglob("*") if p.is_file()) if runs else []
    tfevents = [f for f in files if f.startswith("events.out.tfevents")]
    tb = sorted(p.name for p in (out / "straight" / "tb").rglob("events.out.tfevents.*")) \
        if (out / "straight" / "tb").exists() else []
    two_layers = info["layers"]
    step_want = {"k1": 0, "k1_lse": 2 * two_layers, "k2": 0, "k3a": two_layers,
                 "k3b": two_layers}
    accum = dict(losses=straight, resumed_losses=again, exact=exact,
                 mini_step_at_3=ckpt3["opt_state"]["mini_step"],
                 inner_count_at_4=state["straight"]["opt_state"]["inner"]["count"],
                 wandb_files=files, tfevents=bool(tfevents), tb_files=tb,
                 steps_s=[round(s["wall_s"], 3) for s in probe.steps])
    log(f"phase 26 optimizers (train_s2.sh SFT at {layers} layers, "
        f"{n_params / 1e9:.3f}B parameters, no warmup): "
        f"{json.dumps({n: dict(step_s=round(r['step_s'], 3), optimizer_s=round(r['split_s'].get('optimizer', 0.0), 3), peak_gib=round(r['peak_gib'], 2), state_gib=round(r['state_gib'], 2), loss=round(r['loss'], 6)) for n, r in rows.items()})}; "
        f"accumulation ({two_layers} layers, k 2, --report_to all, {res}): losses "
        f"{straight}, resumed from checkpoint-3 (mini_step {accum['mini_step_at_3']}) "
        f"step 4 {again}, final state equal {exact}, inner count "
        f"{accum['inner_count_at_4']}, launches per micro-step "
        f"{[s['launches'] for s in probe.steps]}; wandb run files {files}; tfevents "
        f"in the wandb run {bool(tfevents)}, under tb/ {tb}")
    if (sorted(straight) != [1, 2, 3, 4] or sorted(again) != [4]
            or again[4] != straight[4] or not exact or accum["mini_step_at_3"] != 1
            or accum["inner_count_at_4"] != 2 or not runs
            or "wandb-history.jsonl" not in files
            or any(s["launches"] != step_want for s in probe.steps + probe_r.steps)):
        raise AssertionError(f"phase 26 accumulation: {accum}")
    shutil.rmtree(out, ignore_errors=True)
    return dict(optimizers=rows, accumulation=accum, n_params=n_params)


def drift_launches(drift: dict, kernel: str) -> dict:
    """Phase 25's launches of one kernel, by family and mode, where nonzero."""
    return {family: {label: row["launches"][kernel] for label, row in rows.items()
                     if row["launches"][kernel]}
            for family, rows in drift.items()}


# ---------------------------------------------------------------------------
# Phase 27: the fp16 kernel forms alone (ROADMAP A.14)
# ---------------------------------------------------------------------------

FP16 = torch.float16


def _randn(gen, shape, dtype) -> torch.Tensor:
    return torch.randn(shape, generator=gen, device="cuda", dtype=dtype)


def _k1_checked(q, k, v, what: str) -> float:
    """K1's bounded and online forms against their plain versions at one
    shape -> the worst max_abs error."""
    from dove_tpu_torch.ops import flash_attention as fa

    worst = 0.0
    for bounded in (True, False):
        out = fa.flash_attention(q, k, v, bounded_logits=bounded)
        torch.cuda.synchronize()
        ref = fa.flash_attention_plain(q, k, v, bounded_logits=bounded)
        err = attn_errors(out, ref)
        log(f"  K1 {what} bounded={bounded}: " + json.dumps(rounded(err, 6)))
        if not bool(torch.isfinite(out).all()) or not within_bars(err):
            raise AssertionError(f"K1 {what} bounded={bounded} disagrees with its "
                                 f"plain version: {err}")
        worst = max(worst, err["max_abs"])
        del out, ref
    return worst


def _k1_timed(q, k, v) -> dict:
    """Each K1 form of q's type timed beside SDPA on the same tensors (phase
    2's time_k1_forms), the bounded form's plain version, and the bound."""
    from dove_tpu_torch.ops import flash_attention as fa

    B, heads, S, _ = q.shape
    forms = time_k1_forms(q, k, v)
    plain_ms = cuda_ms(lambda: fa.flash_attention_plain(q, k, v, bounded_logits=True),
                       1, warmup=0)
    bound_ms, bound_by = _bound(4.0 * S * S * 64 * heads * B, 4 * B * heads * S * 64 * 2)
    return dict(ms=forms["forms_ms"]["bounded"], plain_ms=plain_ms,
                library_ms=forms["sdpa_ms"], bound_ms=bound_ms, bound_by=bound_by,
                shape=[B, heads, S, 64], **forms)


def _fp16_training_attention(gen, B: int, heads: int, S: int) -> dict:
    """K1-lse (the trainer's online form), K3a and K3b in fp16 against their
    plain versions at [B, heads, S, 64], then timed beside SDPA fp16's
    forward and backward (phase 9's _time_training_attention)."""
    from dove_tpu_torch.ops import flash_attention as fa

    scale = 64 ** -0.5
    q, k, v, do = (_randn(gen, (B, heads, S, 64), FP16) for _ in range(4))
    out, lse = fa.flash_attention(q, k, v, with_lse=True)
    torch.cuda.synchronize()
    ref, ref_lse = fa.flash_attention_plain(q, k, v, with_lse=True)
    delta = (do.float() * out.float()).sum(-1)
    dq = fa.flash_bwd_dq_launch(q, k, v, do, lse, delta, scale)
    dk, dv = fa.flash_bwd_dkv_launch(q, k, v, do, lse, delta, scale)
    torch.cuda.synchronize()
    refs = (fa.flash_bwd_dq_plain(q, k, v, do, lse, delta, scale),
            *fa.flash_bwd_dkv_plain(q, k, v, do, lse, delta, scale))
    worst = {"k1_lse": 0.0, "k3a": 0.0, "k3b": 0.0}
    lse_err = float((lse - ref_lse).abs().max())
    for key, got, want in (("k1_lse", out, ref), ("k3a", dq, refs[0]),
                           ("k3b", dk, refs[1]), ("k3b", dv, refs[2])):
        err = attn_errors(got, want)
        if not bool(torch.isfinite(got).all()) or not within_grad_bars(err):
            raise AssertionError(f"fp16 {key} disagrees with its plain version at "
                                 f"[{B}, {heads}, {S}, 64]: {err}")
        worst[key] = max(worst[key], err["max_abs"])
    if not lse_err <= K1_LSE_ABS_TOL:
        raise AssertionError(f"fp16 K1's logsumexp is off by {lse_err}")
    del out, ref, ref_lse, dq, dk, dv, refs
    timing = _time_training_attention(q, k, v, do, lse, delta, forms=False)
    timing.update(worst=worst, lse_max_abs_err=lse_err)
    del q, k, v, do, lse, delta
    torch.cuda.empty_cache()
    return timing


def _fp16_conv_kernels(gen) -> dict:
    """K4 with the fp16 epilogue (the VAE's form: offset term and bias, NCDHW)
    equal to its plain version, K5 with bf16 operands and fp16 out within
    its bar plus one fp16 ulp, and the quantizer's pass on fp16 input equal,
    at phase 12's main shape; each timed beside its plain version."""
    import torch.nn.functional as F

    from dove_tpu_torch.ops import conv3d_int8 as conv
    from dove_tpu_torch.ops import quant

    shape = CONV_SHAPES[0]
    B, Fo, Ho, Wo, cin, cout, kt = shape
    x, w, scale = _conv_inputs(shape, gen, int8=True)
    addend = torch.randn((cout, min(Ho, 3), min(Wo, 3)), generator=gen, device="cuda")
    bias = torch.randn(cout, generator=gen, device="cuda")
    scale = scale * 1e3
    out = conv.conv_taps(x, w, scale, kt, FP16, True, addend=addend, bias=bias)
    torch.cuda.synchronize()
    ref = conv.conv_taps_plain(x, w, scale, kt, FP16, True, addend=addend, bias=bias)
    if out.dtype != FP16 or not torch.equal(out, ref):
        raise AssertionError(f"K4's fp16 epilogue differs from its plain version: max "
                             f"|diff| {float((out.float() - ref.float()).abs().max())}")
    k4 = dict(shape=list(shape), max_abs_err=0.0,
              ms=cuda_ms(lambda: conv.conv_taps_launch(x, w, scale, kt, FP16, True,
                                                       addend, bias), 10),
              plain_ms=cuda_ms(lambda: conv.conv_taps_plain(
                  x, w, scale, kt, FP16, True, addend=addend, bias=bias), 1, warmup=0))
    k4["bound_ms"], k4["bound_by"], _ = _conv_bound(shape, 1, 2, PEAK_INT8_OPS)
    del x, w, out, ref
    torch.cuda.empty_cache()

    x, w, _ = _conv_inputs(shape, gen, int8=False)
    out = conv.conv_taps(x, w, None, kt, FP16, True)
    torch.cuda.synchronize()
    ref = conv.conv_taps_plain(x, w, None, kt, torch.float32, True)
    slack = _k5_bar(ref, kt, cin)
    _, exponent = torch.frexp(ref.abs())
    ulp = torch.ldexp(torch.ones_like(ref), exponent - 11)
    over = float(((out.float() - ref).abs() - ulp - slack).max())
    err = float((out.float() - ref).abs().max())
    if out.dtype != FP16 or not over <= 0 or not bool(torch.isfinite(out).all()):
        raise AssertionError(f"K5's fp16 out differs from its plain version by {err} "
                             f"(bar {slack} and one fp16 ulp)")
    w5 = w.view(kt, 3, 3, cout, cin).permute(3, 4, 0, 1, 2)
    x_cl = x.permute(0, 4, 1, 2, 3)
    w_cl = w5.contiguous(memory_format=torch.channels_last_3d)
    k5 = dict(shape=list(shape), max_abs_err=err, bar=slack,
              ms=cuda_ms(lambda: conv.conv_taps_launch(x, w, None, kt, FP16, True), 10),
              plain_ms=cuda_ms(lambda: conv.conv_taps_plain(x, w, None, kt, FP16, True),
                               1, warmup=0),
              library_ms=cuda_ms(lambda: F.conv3d(x_cl, w_cl), 10),
              library_call="F.conv3d of the same bf16 operands, channels_last_3d, "
                           "bf16 out (cuDNN has no bf16-in, fp16-out conv)")
    k5["bound_ms"], k5["bound_by"], _ = _conv_bound(shape, 2, 2, PEAK_BF16_FLOPS)
    del x, w, out, ref, ulp, x_cl, w_cl, w5
    torch.cuda.empty_cache()

    qshape = (B, cin, Fo + kt - 1, Ho, Wo)
    x = torch.nn.functional.silu(torch.randn(qshape, generator=gen, device="cuda") * 2
                                 ).to(FP16)
    eq = torch.rand(cin, generator=gen, device="cuda") + 0.5
    s, m = quant.asym_grid(x, eq_inv=eq, channel_dim=1)
    codes = conv.quantize_pack(x, s, m, eq, 1)
    torch.cuda.synchronize()
    wrong = int((codes != conv.quantize_pack_plain(x, s, m, eq, 1)).sum())
    if wrong:
        raise AssertionError(f"the quantizer's pass on fp16 differs in {wrong} codes")
    quantizer = dict(shape=list(qshape), max_abs_err=0.0,
                     ms=cuda_ms(lambda: conv.quantize_pack_launch(x, s, m, eq, 1), 10),
                     plain_ms=cuda_ms(lambda: conv.quantize_pack_plain(x, s, m, eq, 1), 3),
                     bound_ms=(x.numel() * 2 + codes.numel() + 4 * cin) / PEAK_BYTES * 1e3,
                     bound_by="bytes")
    del x, codes
    for c in (conv.launches_w8a8, conv.launches_w8a8_kt1, conv.launches_bf16,
              conv.launches_quantize):
        c.reset()
    torch.cuda.empty_cache()
    return dict(k4=k4, k5=k5, quantizer=quantizer)


def phase_fp16_kernels(seq_5b: int, heads_5b: int, seq_2b: int, heads_2b: int,
                       train_2b: int) -> dict:
    """Phase 27: every fp16 form against its plain version, and K1 in bf16 at
    the 2B's serving shape. K1's four forms and K2 (fp16 V and O) at the 2B's
    [1, 30, 34786, 64] and the 5B's [1, 48, 19426, 64], K1-lse, K3a and K3b at
    the stage-1 shapes of both ([2, 30, 5826, 64], [2, 48, 3426, 64]), each
    timed beside SDPA in fp16 with its bound; the ragged Sq, Skv sweep and the
    NaN-neighbour heads of phases 2, 5 and 9 in fp16; K4, K5 and the
    quantizer with fp16 outputs and input at phase 12's main shape."""
    from dove_tpu_torch.ops import flash_attention as fa

    gen = torch.Generator(device="cuda").manual_seed(27)
    scale = 64 ** -0.5
    res: dict = {"k1": {}, "k2": {}, "train": {}}
    worst = {"k1": 0.0, "k2": 0.0}
    for name, heads, S in (("2b", heads_2b, seq_2b), ("5b", heads_5b, seq_5b)):
        q, k, v = (_randn(gen, (1, heads, S, 64), FP16) for _ in range(3))
        worst["k1"] = max(worst["k1"], _k1_checked(q, k, v, f"fp16 {name} S={S}"))
        res["k1"][name] = _k1_timed(q, k, v)
        q8, k8, factor = fa.quantize_qk_pair(q, k, scale)
        out = fa.flash_qk8_launch(q8, k8, v, factor)
        torch.cuda.synchronize()
        err = attn_errors(out, fa.flash_attention_qk8_plain(q8, k8, v, factor))
        if out.dtype != FP16 or not bool(torch.isfinite(out).all()) or not within_bars(err):
            raise AssertionError(f"K2 with fp16 V disagrees with its plain version at "
                                 f"{name} S={S}: {err}")
        worst["k2"] = max(worst["k2"], err["max_abs"])
        macs = float(S) * S * 64 * heads
        ops_s = 2 * macs / PEAK_INT8_OPS + 2 * macs / PEAK_BF16_FLOPS
        nbytes = heads * S * 64 * (1 + 1 + 2 + 2)
        res["k2"][name] = dict(
            ms=cuda_ms(lambda: fa.flash_qk8_launch(q8, k8, v, factor), 10),
            k1_same_call_ms=cuda_ms(lambda: fa.flash_attention(q, k, v, bounded_logits=True),
                                    10),
            plain_ms=cuda_ms(lambda: fa.flash_attention_qk8_plain(q8, k8, v, factor), 1, 0),
            library_ms=res["k1"][name]["library_ms"],
            bound_ms=max(ops_s, nbytes / PEAK_BYTES) * 1e3,
            bound_by="operations" if ops_s >= nbytes / PEAK_BYTES else "bytes",
            shape=[1, heads, S, 64], max_abs_err=err["max_abs"])
        del q, k, v, q8, k8, out
        torch.cuda.empty_cache()
    # K1 in bf16 at the 2B's serving shape
    q, k, v = (_randn(gen, (1, heads_2b, seq_2b, 64), torch.bfloat16) for _ in range(3))
    k1_bf16_err = _k1_checked(q, k, v, f"bf16 2b S={seq_2b}")
    res["k1_bf16_2b"] = dict(_k1_timed(q, k, v), max_abs_err=k1_bf16_err)
    del q, k, v
    torch.cuda.empty_cache()
    for name, heads, S in (("2b", heads_2b, train_2b), ("5b", heads_5b, TRAIN_SEQ)):
        res["train"][name] = _fp16_training_attention(gen, TRAIN_BATCH, heads, S)
    edges = dict(k1=k1_edge_cases(False, FP16), k1_lse=k1_edge_cases(True, FP16),
                 k2=k2_edge_cases(FP16), k3=k3_edge_cases(FP16))
    worst["k1"] = max(worst["k1"], edges["k1"]["max_abs"])
    worst["k2"] = max(worst["k2"], edges["k2"]["max_abs"])
    worst["k1_lse"] = max([edges["k1_lse"]["max_abs"]]
                          + [t["worst"]["k1_lse"] for t in res["train"].values()])
    worst["lse"] = max([edges["k1_lse"]["lse"]]
                       + [t["lse_max_abs_err"] for t in res["train"].values()])
    for key in ("k3a", "k3b"):
        worst[key] = max([edges["k3"][key]] + [t["worst"][key]
                                               for t in res["train"].values()])
    res["conv"] = _fp16_conv_kernels(gen)
    res["worst"] = worst
    for c in _k3_counters().values():
        c.reset()
    torch.cuda.empty_cache()
    log("phase 27 fp16 kernels: worst max_abs_err " + json.dumps(rounded(worst, 6))
        + "; K1 fp16 " + json.dumps(rounded({n: {k: r[k] for k in (
            "ms", "plain_ms", "library_ms", "bound_ms", "exp_floor_ms", "forms_ms",
            "sdpa_ratio", "shape")} for n, r in res["k1"].items()}))
        + "; K2 fp16 V " + json.dumps(rounded(res["k2"]))
        + "; K1 bf16 at the 2B's shape " + json.dumps(rounded({k: res["k1_bf16_2b"][k] for k in (
            "ms", "plain_ms", "library_ms", "bound_ms", "exp_floor_ms", "forms_ms",
            "sm_clock_mhz", "shape")}))
        + "; training fp16 " + json.dumps(rounded({n: {k: t[k] for k in (
            "k1_lse_ms", "k3a_ms", "k3b_ms", "k1_lse_plain_ms", "k3a_plain_ms",
            "k3b_plain_ms", "sdpa_fwd_ms", "sdpa_bwd_ms", "k1_lse_bound_ms",
            "k3a_bound_ms", "k3b_bound_ms", "shape")} for n, t in res["train"].items()}))
        + "; conv " + json.dumps(rounded(res["conv"])))
    return res


# ---------------------------------------------------------------------------
# Phase 28: the 2B serving path at 30 layers, and fp16 serving
# ---------------------------------------------------------------------------

def _logit_probe(record: list):
    """For the length of a ``with``: every DiT attention also records the
    largest scaled logit over its heads (Q K^T in the model type, fp32 sums,
    one head at a time), in ``record``, one float a layer."""
    import contextlib

    from dove_tpu_torch.models import dit as dit_mod

    inner = dit_mod.full_attention

    def probe(q, k, v, **kw):
        tops = [(q[b, h] @ k[b, h].T).amax() for b in range(q.shape[0])
                for h in range(q.shape[1])]
        record.append(float(torch.stack(tops).float().max()) * q.shape[-1] ** -0.5)
        return inner(q, k, v, **kw)

    @contextlib.contextmanager
    def patched():
        dit_mod.full_attention = probe
        try:
            yield
        finally:
            dit_mod.full_attention = inner

    return patched()


def _serve(cfg, dit, vae, dtype, clip, quantize=None, backend=None,
           sample_posterior=False, window_plan=None, logits: list | None = None,
           **flags) -> dict:
    """One staged clip through DovePipeline.process_frames: the uint8 output,
    wall, split, peak, the launches of every kernel (and what the window
    plan predicts for the conv kernels), and whether every DiT output
    (x-hat_0) was finite. ``window_plan`` replaces the pipeline's VAE window
    plan; with ``logits``, the first DiT pass runs once more after the timed
    clip, under _logit_probe, and its largest logit per layer lands there."""
    from dove_tpu_torch.models import vae as vae_mod
    from dove_tpu_torch.pipeline import DovePipeline

    pipe = DovePipeline(
        config=cfg, dit=dit, vae=vae,
        prompt_embedding=torch.zeros((cfg.dit.max_text_seq_length,
                                      cfg.dit.text_embed_dim), dtype=dtype),
        dtype=dtype, device="cuda", attention_backend=backend,
        sample_posterior=sample_posterior, vae_tiling=True, output_uint8=True,
        quantize=quantize, **flags)
    if window_plan is not None:
        pipe._window_budget = lambda: window_plan
    finite, first = [], []
    inner = pipe._denoise

    def checked(*a, **kw):
        if not first and logits is not None:
            first.append((a, kw))
        x0 = inner(*a, **kw)
        finite.append(bool(torch.isfinite(x0).all()))
        return x0

    pipe._denoise = checked
    counters = _conv_counters()
    torch.cuda.reset_peak_memory_stats()
    for c in counters.values():
        c.reset()
    t0 = time.perf_counter()
    try:
        out = pipe.process_frames(clip, seed=0)
    finally:
        vae_mod.set_pallas_conv(False)
    wall = time.perf_counter() - t0
    counts = {n: c.count for n, c in counters.items()}
    peak = torch.cuda.max_memory_allocated()
    if logits is not None:
        with _logit_probe(logits), torch.no_grad():
            inner(*first[0][0], **first[0][1])
    return dict(out=out, wall_s=wall, stage_s=dict(pipe.stage_times),
                peak_bytes=peak, **counts,
                predicted=predicted_conv_launches(pipe, *clip.shape[:3]),
                dit_finite=all(finite) and bool(finite), passes=len(finite))


def _fp16_cli() -> dict:
    """``python -m dove_tpu_torch.inference --preset cogvideox-2b --dtype
    float16 --is_vae_st --png_save`` at 2 layers on phase 24's two mp4 clips,
    held to load_pipeline + process_frames on the decoded input."""
    import shutil
    from pathlib import Path

    from dove_tpu_torch.inference import build_parser, load_pipeline, main as cli_main
    from dove_tpu_torch.inference import process_kwargs
    from dove_tpu_torch.io import video as video_io
    from dove_tpu_torch.ops import flash_attention as fa

    root = Path(VIDEO_DIR + "_2b")
    shutil.rmtree(root, ignore_errors=True)
    (root / "in").mkdir(parents=True)
    clips = {}
    for i, (f, h, w) in enumerate(VIDEO_CLIPS):
        path = video_io.save_video(smooth_clip(300 + i, f, h, w).numpy(),
                                   root / "in" / f"clip{i}.mp4", fps=16,
                                   pixel_format="rgb")
        clips[path.name] = video_io.read_video_frames(path)
    argv = ["--input_dir", str(root / "in"), "--output_path", str(root / "png"),
            "--preset", "cogvideox-2b", "--dtype", "float16", "--is_vae_st",
            "--png_save", "--seed", "0"]
    with _two_layer_presets("cogvideox-2b"):
        fa.launches.reset()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        cli_main(argv)
        torch.cuda.synchronize()
        wall, k1 = time.perf_counter() - t0, fa.launches.count
        args = build_parser().parse_args(argv)
        pipe = load_pipeline(args)
    layers = pipe.config.dit.num_layers
    checks = {}
    for name, frames in clips.items():
        want = pipe.process_frames(frames, **process_kwargs(args))
        got = np.round(video_io.read_image_folder(root / "png" / Path(name).stem)
                       * 255).astype(np.uint8)
        db = psnr_u8(got, want)
        checks[name] = dict(png_vs_in_process_db=db, identical=bool(np.array_equal(got, want)),
                            shape=list(got.shape))
        if got.shape != want.shape or not db >= PSNR_BAR_DB:
            raise AssertionError(f"phase 28 CLI {name}: {checks[name]}")
    if pipe.dtype != FP16 or pipe.config.dit.patch_size_t is not None:
        raise AssertionError(f"phase 28 CLI: {pipe.dtype}, pt {pipe.config.dit.patch_size_t}")
    if k1 != layers * len(clips):
        raise AssertionError(f"phase 28 CLI: K1 {k1}, want {layers} x {len(clips)}")
    del pipe
    shutil.rmtree(root, ignore_errors=True)
    torch.cuda.empty_cache()
    return dict(wall_s=wall, k1=k1, layers=layers, checks=checks)


def phase_2b_serving(main_out: np.ndarray) -> dict:
    """Phase 28: CogVideoX-2B at full width and depth (30 layers; weights from
    int8_drift_report.realistic_params, the gaussian family, in bf16) on the
    main path's 32-frame 180x320 clip, staged, in bf16, in fp16 (the same
    weights cast) and in fp16 int8-dit (on the bf16 run's window plan): K1
    (K2) launches = 30 a DiT pass, the split and peak, each against bf16 in
    PSNR, the largest scaled logit of every layer of the fp16 DiT pass (run
    again after the timed clip; fp16's P overflows past ln 65504 ~ 11.09);
    the 2B at 2 layers through K1 and through the plain attention in bf16
    and fp16 (>= 40 dB), and in fp16 int8-dit-dec with hand_conv (K4, K5 and
    the quantizer in fp16, launches as the window plan predicts); the 5B at
    42 layers in fp16 against phase 4's bf16 clip (the same seeds and
    posterior draws); and the CLI with --preset cogvideox-2b --dtype float16
    at 2 layers on mp4 clips, held to the in-process frames."""
    import copy
    import dataclasses

    from dove_tpu_torch import cogvideox1_5_5b, cogvideox_2b, init_dit_params
    from dove_tpu_torch import init_vae_params
    from dove_tpu_torch import int8_drift_report as drift_mod

    cfg = cogvideox_2b()
    layers = cfg.dit.num_layers
    clip = np.random.default_rng(4).uniform(
        0, 1, (CLIP_FRAMES, CLIP_H, CLIP_W, 3)).astype(np.float32)
    t0 = time.perf_counter()
    dit, vae = drift_mod.empty_models(cfg, torch.bfloat16, torch.device("cuda"))
    drift_mod.realistic_params(dit, seed=1)
    drift_mod.realistic_params(vae, seed=2)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in dit.parameters())
    runs = {}
    runs["bf16"] = _serve(cfg, dit, vae, torch.bfloat16, clip)
    logits: list = []
    dit16, vae16 = copy.deepcopy(dit).to(FP16), copy.deepcopy(vae).to(FP16)
    runs["fp16"] = _serve(cfg, dit16, vae16, FP16, clip, logits=logits)
    del dit16, vae16
    torch.cuda.empty_cache()
    # int8-dit in fp16, the 2B's published precision: K2 with fp16 V and O; on
    # the bf16 run's VAE window plan (the int8 modes plan larger windows, and
    # with random weights the plan alone moves the output: the drift
    # report's rule), so that the PSNR against bf16 is the DiT's
    dit16, vae16 = copy.deepcopy(dit).to(FP16), copy.deepcopy(vae).to(FP16)
    runs["int8-dit fp16"] = _serve(cfg, dit16, vae16, FP16, clip, quantize="int8-dit",
                                   window_plan=drift_mod.BF16_WINDOW_PLAN)
    del dit16, vae16
    torch.cuda.empty_cache()
    want_shape = (CLIP_FRAMES, CLIP_H * cfg.upscale, CLIP_W * cfg.upscale, 3)
    for name, r in runs.items():
        kernel = "k2" if name.startswith("int8-dit") else "k1"
        other = "k1" if kernel == "k2" else "k2"
        if (r["out"].shape != want_shape or not r["dit_finite"] or r["passes"] != 1
                or not float(r["out"].std()) > 0):
            raise AssertionError(f"phase 28 {name}: output {r['out'].shape}, DiT finite "
                                 f"{r['dit_finite']} over {r['passes']} passes")
        if r[kernel] != layers * r["passes"] or r[other]:
            raise AssertionError(f"phase 28 {name}: K1 {r['k1']}, K2 {r['k2']}, want "
                                 f"{layers} {kernel} a pass")
    if len(logits) != layers or not all(math.isfinite(x) for x in logits):
        raise AssertionError(f"phase 28 fp16 logits per layer: {logits}")
    psnr_vs_bf16 = {n: psnr_u8(runs[n]["out"], runs["bf16"]["out"])
                    for n in ("fp16", "int8-dit fp16")}

    # 2 layers: through the kernels and through the plain attention
    two = dataclasses.replace(cfg, dit=dataclasses.replace(cfg.dit, num_layers=2))
    del dit
    torch.cuda.empty_cache()
    small = np.random.default_rng(3).uniform(0, 1, (9, 96, 160, 3)).astype(np.float32)
    dit_2l, _ = drift_mod.empty_models(two, torch.bfloat16, torch.device("meta"))
    dit_2l = drift_mod.realistic_params(dit_2l.to_empty(device="cuda"), seed=1)
    two_layer = {}
    for dtype in (torch.bfloat16, FP16):
        d, v = (dit_2l, vae) if dtype == torch.bfloat16 else (
            copy.deepcopy(dit_2l).to(FP16), copy.deepcopy(vae).to(FP16))
        k = _serve(two, d, v, dtype, small)
        p = _serve(two, d, v, dtype, small, backend="plain")
        db = psnr_u8(k["out"], p["out"])
        two_layer[str(dtype).split(".")[1]] = dict(psnr_db=db, k1=k["k1"], plain_k1=p["k1"])
        if not db >= PSNR_BAR_DB or k["k1"] != 2 or p["k1"]:
            raise AssertionError(f"phase 28 2B 2 layers {dtype}: {two_layer}")
    # the fp16 int8 VAE route at 2 layers: int8-dit-dec (K2 with fp16 V, K4
    # with the fp16 epilogue, the quantizer on fp16 activations) with
    # hand_conv (K5 with fp16 out on the float convs), launches as planned
    from dove_tpu_torch.ops import quant

    d16, v16 = copy.deepcopy(dit_2l).to(FP16), copy.deepcopy(vae).to(FP16)
    vae_route = _serve(two, d16, v16, FP16, small, quantize="int8-dit-dec",
                       vae_exclude=("lowres",), vae_calib=quant.synthetic_vae_calib(v16),
                       hand_conv=True)
    want = dict(vae_route["predicted"], k1=0, k2=2)
    got = {n: vae_route[n] for n in want}
    if (got != want or not all(got[n] for n in ("k4", "k5", "quantize"))
            or not vae_route["dit_finite"]):
        raise AssertionError(f"phase 28 fp16 int8 VAE route: launches {got}, want {want}")
    del dit_2l, vae, d16, v16
    torch.cuda.empty_cache()

    # the 5B at 42 layers in fp16, against phase 4's bf16 clip
    cfg5 = cogvideox1_5_5b()
    dit5 = init_dit_params(cfg5.dit, seed=0, device="cuda", dtype=torch.bfloat16).to(FP16)
    vae5 = init_vae_params(cfg5.vae, seed=1, device="cuda", dtype=torch.bfloat16).to(FP16)
    run5 = _serve(cfg5, dit5, vae5, FP16, clip, sample_posterior=True)
    del dit5, vae5
    torch.cuda.empty_cache()
    db5 = psnr_u8(run5["out"], main_out)
    if (run5["out"].shape != main_out.shape or not run5["dit_finite"]
            or run5["k1"] != cfg5.dit.num_layers):
        raise AssertionError(f"phase 28 5B fp16: {run5['out'].shape}, finite "
                             f"{run5['dit_finite']}, K1 {run5['k1']}")
    cli = _fp16_cli()

    def summary(r):
        return dict(wall_s=r["wall_s"], stage_s=r["stage_s"],
                    peak_gib=r["peak_bytes"] / 2**30, k1=r["k1"], k2=r["k2"])

    vae_launches = {n: vae_route[n] for n in ("k2", "k4", "k4_kt1", "k5", "quantize")}

    log(f"phase 28 2B serving ({layers} layers, {n_params / 1e9:.3f}B DiT params, "
        f"realistic_params gaussian; attention [1, {cfg.dit.num_attention_heads}, "
        f"{main_path_seq_len(cfg)}, 64]; weights {init_s:.1f}s): "
        + json.dumps(rounded({n: summary(r) for n, r in runs.items()}))
        + f"; PSNR against bf16 {json.dumps(rounded(psnr_vs_bf16, 2))}; largest scaled "
        f"logit per layer (fp16) {json.dumps([round(x, 3) for x in logits])} (max "
        f"{max(logits):.3f}, fp16 P overflows past {math.log(65504):.3f}); 2 layers "
        f"kernel vs plain {json.dumps(rounded(two_layer, 2))}; fp16 int8-dit-dec + "
        f"hand_conv (2 layers) launches {json.dumps(vae_launches)} as planned; 5B "
        f"fp16 (42 layers) "
        f"{json.dumps(rounded(summary(run5)))}, {db5:.2f} dB against phase 4's bf16 "
        f"clip; CLI --preset cogvideox-2b --dtype float16 ({cli['layers']} layers) "
        f"{cli['wall_s']:.1f}s, K1 {cli['k1']}, "
        + json.dumps(rounded(cli["checks"], 2)))
    return dict(runs={n: summary(r) for n, r in runs.items()}, psnr_vs_bf16=psnr_vs_bf16,
                logits=logits, two_layer=two_layer, vae_route=vae_launches,
                five_b_fp16=summary(run5),
                five_b_fp16_db=db5, cli=dict(wall_s=cli["wall_s"], k1=cli["k1"]))


# ---------------------------------------------------------------------------
# Phase 29: training in fp16 and the 2B's stage 1
# ---------------------------------------------------------------------------

# fp16 training as the JAX package runs it has no loss scaling: at full
# width the LoRA gradients of q, k and v underflow to 0 (the loss's mean over
# ~7e5 latent values puts ~1e-6 on each output gradient). Phase 29 records
# that, and compares the kernels with the plain attention on the loss scaled
# by this factor (and the gradients unscaled), where fp16 holds them.
FP16_CHECK_LOSS_SCALE = 2.0 ** 16


def _scaled_grads(tr, batch, scale: float) -> tuple[float, list]:
    """The trainer's loss and the gradients of its trainable tensors, the
    backward taken on loss * scale and the gradients divided by it."""
    params = tr.trainable_tensors()
    for p in params:
        p.grad = None
    loss, _ = tr.compute_loss(batch, tr.global_step)
    (loss * scale).backward()
    grads = [torch.zeros_like(p) if p.grad is None else p.grad / scale for p in params]
    for p in params:
        p.grad = None
    return float(loss), grads


def _train_kernel_vs_plain(cfg, precision: str, label: str) -> dict:
    """One stage-1 step (loss and LoRA gradients) of ``cfg`` in ``precision``
    through the kernels and through the plain attention, from one LoRA (B
    nonzero) and batch (phase 10's check); the trainer's own gradients'
    share of zeros per leaf, then the comparison on the scaled loss."""
    import dataclasses

    from dove_tpu_torch.train.trainer import DOVES1Trainer

    args = dataclasses.replace(_train_args("build/chip_smoke_train"),
                               mixed_precision=precision)
    tr = DOVES1Trainer(args, pipeline_config=cfg, device="cuda")
    tr.load_components()
    with torch.no_grad():
        gen = torch.Generator(device="cuda").manual_seed(10)
        for ab in tr.lora_params.values():
            ab["B"].copy_(torch.randn(ab["B"].shape, generator=gen, device="cuda") * 1e-2)
    batch = tr.device_batch(train_batch(seed=10))
    names = [f"{t}.{ab}" for t in tr.lora_params for ab in ("A", "B")]
    _, _, unscaled = tr.loss_and_grads(batch)
    zeros = {n: float((g == 0).float().mean()) for n, g in zip(names, unscaled)}
    del unscaled
    scale = FP16_CHECK_LOSS_SCALE if precision == "fp16" else 1.0
    runs = {}
    for backend in (None, "plain"):
        tr.attention_backend = backend
        for c in _k3_counters().values():
            c.reset()
        loss, grads = _scaled_grads(tr, batch, scale)
        runs[backend] = (loss, grads, {n: c.count for n, c in _k3_counters().items()})
    (k_loss, k_grads, k_counts), (p_loss, p_grads, p_counts) = runs[None], runs["plain"]
    layers = cfg.dit.num_layers
    want = {"k1": 0, "k1_lse": 2 * layers, "k2": 0, "k3a": layers, "k3b": layers}

    def stats(g):
        return dict(finite=bool(torch.isfinite(g).all()), max=float(g.abs().max()),
                    zero=float((g == 0).float().mean()))

    leaves = {n: dict(kernel=stats(g), plain=stats(h), rel_rms=_rel_rms(g, h))
              for n, g, h in zip(names, k_grads, p_grads)}
    rel = [x["rel_rms"] for x in leaves.values()]
    loss_rel = abs(k_loss - p_loss) / abs(p_loss)
    out = dict(loss=k_loss, plain_loss=p_loss, loss_rel=loss_rel, worst_grad_rel_rms=max(rel),
               launches=k_counts, loss_scale=scale, unscaled_zero_share=zeros)
    if (k_counts != want or any(p_counts.values()) or not math.isfinite(k_loss)
            or not loss_rel <= TRAIN_LOSS_REL_TOL
            or not max(rel) <= TRAIN_GRAD_REL_RMS_TOL
            or not all(float(g.abs().max()) > 0 for g in k_grads)):
        raise AssertionError(f"phase 29 {label} {precision}: {out}, plain launches "
                             f"{p_counts}, leaves {json.dumps(rounded(leaves, 6))}")
    del tr, batch, runs, k_grads, p_grads
    torch.cuda.empty_cache()
    return out


def _recipe_steps(precision: str) -> dict:
    """Three steps of the stage-1 recipe with --base_preset cogvideox-2b at 30
    layers in ``precision``: launches per step, finite losses, split, peak."""
    import dataclasses

    from dove_tpu_torch.train.trainer import DOVES1Trainer

    args = dataclasses.replace(_train_args("build/chip_smoke_train"),
                               base_preset="cogvideox-2b", mixed_precision=precision)
    t0 = time.perf_counter()
    tr = DOVES1Trainer(args, device="cuda")
    tr.load_components()
    tr.prepare_optimizer(TRAIN_STEPS)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    layers = tr.config.dit.num_layers
    if tr.config.dit.patch_size_t is not None or tr.dtype != {"bf16": torch.bfloat16,
                                                              "fp16": FP16}[precision]:
        raise AssertionError(f"phase 29: base_preset gave {tr.config.dit}, {tr.dtype}")
    batch = tr.device_batch(train_batch(seed=11))
    counters = _k3_counters()
    want = {"k1": 0, "k1_lse": 2 * layers, "k2": 0, "k3a": layers, "k3b": layers}
    torch.cuda.reset_peak_memory_stats()
    steps = []
    for _ in range(TRAIN_STEPS):
        for c in counters.values():
            c.reset()
        t0 = time.perf_counter()
        loss, _, gnorm = tr.train_step(batch)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        tr.global_step += 1
        per_step = {n: c.count for n, c in counters.items()}
        steps.append(dict(wall_s=wall, loss=float(loss), grad_norm=float(gnorm),
                          split_s=dict(tr.step_times), launches=per_step))
        if per_step != want or not math.isfinite(float(loss)) or not float(gnorm) > 0:
            raise AssertionError(f"phase 29 2B {precision} step {tr.global_step}: "
                                 f"{steps[-1]}, want launches {want}")
    peak = torch.cuda.max_memory_allocated()
    # LoRA B starts at 0: which targets the steps moved (fp16's unscaled
    # gradients of q, k and v underflow, see FP16_CHECK_LOSS_SCALE)
    moved = {t: float(ab["B"].detach().abs().max()) for t, ab in tr.lora_params.items()}
    if not moved["to_out"] > 0:
        raise AssertionError(f"phase 29 2B {precision}: no LoRA B moved: {moved}")
    del tr, batch
    torch.cuda.empty_cache()
    return dict(steps=steps, peak_bytes=peak, init_s=init_s, layers=layers,
                lora_b_max=moved,
                step_median_s=statistics.median(s["wall_s"] for s in steps[1:]))


def phase_fp16_training() -> dict:
    """Phase 29: a 2-layer stage-1 step in fp16 through the kernels and the
    plain attention for the 5B and the 2B (the bars of phase 10, on the loss
    scaled by FP16_CHECK_LOSS_SCALE; the unscaled gradients' share of zeros
    recorded), then three steps of the stage-1 recipe with --base_preset
    cogvideox-2b at 30 layers in bf16 and in fp16 (K1-lse twice a layer a
    step with checkpointing, K3a and K3b once; finite losses; which LoRA
    targets moved)."""
    import dataclasses

    from dove_tpu_torch import cogvideox1_5_5b, cogvideox_2b

    checks = {}
    for name, base in (("5b", cogvideox1_5_5b()), ("2b", cogvideox_2b())):
        cfg = dataclasses.replace(base, dit=dataclasses.replace(base.dit, num_layers=2))
        checks[name] = _train_kernel_vs_plain(cfg, "fp16", name)
    recipe = {p: _recipe_steps(p) for p in ("bf16", "fp16")}
    log("phase 29 training: 2 layers, fp16, kernels vs plain "
        + json.dumps(rounded(checks, 6)) + f"; stage-1 recipe, base_preset "
        f"cogvideox-2b ({recipe['bf16']['layers']} layers, attention [{TRAIN_BATCH}, 30, "
        f"{train_seq_len(cogvideox_2b())}, 64]): " + json.dumps(rounded({
            p: dict(step_median_s=r["step_median_s"], init_s=r["init_s"],
                    peak_gib=r["peak_bytes"] / 2**30,
                    losses=[s["loss"] for s in r["steps"]],
                    split_s=r["steps"][-1]["split_s"],
                    launches_per_step=r["steps"][-1]["launches"])
            for p, r in recipe.items()}))
        + "; max |LoRA B| after the steps (0 at init) " + json.dumps({
            p: {t: float(f"{x:.3e}") for t, x in r["lora_b_max"].items()}
            for p, r in recipe.items()}))
    return dict(checks=checks, recipe=recipe)


def fp16_kernel_rows(fp16: dict, serving: dict, training: dict) -> list[dict]:
    """The kernels line's rows of the fp16 forms (phases 27-29): times from
    phase 27 at the 2B's shapes (the 5B's beside them), launches from phase
    28's fp16 runs at 30 layers (K4, K5 and the quantizer: its 2-layer fp16
    int8-dit-dec + hand_conv clip) and phase 29's fp16 recipe steps."""
    fwd = "dove_tpu_torch/csrc/flash_fwd_sm90.cu"
    bwd = "dove_tpu_torch/csrc/flash_bwd_sm90.cu"
    conv_src = "dove_tpu_torch/csrc/conv3d_taps_sm90.cu"
    steps = training["recipe"]["fp16"]["steps"]

    def recipe(key):
        return sum(s["launches"][key] for s in steps)

    def row(name, source, replaces, launches, max_err, t, **extra):
        return dict(name=name, route="cuda", source=source, replaces=replaces,
                    launches=launches, max_abs_err=max_err, ms=t["ms"],
                    plain_ms=t["plain_ms"], bound_ms=t["bound_ms"],
                    bound_by=t["bound_by"], library_ms=t.get("library_ms"),
                    shape=t.get("shape"), **extra)

    k1, k2, tr = fp16["k1"], fp16["k2"], fp16["train"]
    sdpa = "scaled_dot_product_attention on the same fp16 q, k, v"
    rows = [
        row("flash_fwd_f16", fwd, "dove_tpu/ops/pallas/flash_attention.py:75",
            serving["runs"]["fp16"]["k1"], fp16["worst"]["k1"], k1["2b"],
            library_call=sdpa, forms_ms=k1["2b"]["forms_ms"],
            exp_floor_ms=k1["2b"]["exp_floor_ms"],
            five_b={k: k1["5b"][k] for k in ("ms", "plain_ms", "library_ms", "bound_ms",
                                              "forms_ms", "shape")},
            five_b_launches=serving["five_b_fp16"]["k1"],
            bf16_at_2b_shape={k: fp16["k1_bf16_2b"][k] for k in (
                "ms", "plain_ms", "library_ms", "bound_ms", "forms_ms", "exp_floor_ms",
                "max_abs_err", "shape")},
            bf16_2b_launches=serving["runs"]["bf16"]["k1"],
            largest_logit_by_layer=serving["logits"]),
        row("flash_fwd_qk8_f16", fwd, "dove_tpu/ops/pallas/flash_attention.py:107",
            serving["runs"]["int8-dit fp16"]["k2"], fp16["worst"]["k2"], k2["2b"],
            library_call="scaled_dot_product_attention on the fp16 q, k, v: a "
                         "yardstick of a different function (fp16 Q K^T)",
            k1_same_call_ms=k2["2b"]["k1_same_call_ms"],
            five_b={k: k2["5b"][k] for k in ("ms", "plain_ms", "bound_ms", "shape")},
            vae_route_launches=serving["vae_route"]["k2"]),
        row("flash_fwd_lse_f16", fwd, "dove_tpu/ops/pallas/flash_attention.py:154",
            recipe("k1_lse"), fp16["worst"]["k1_lse"],
            dict(ms=tr["2b"]["k1_lse_ms"], plain_ms=tr["2b"]["k1_lse_plain_ms"],
                 bound_ms=tr["2b"]["k1_lse_bound_ms"], bound_by=tr["2b"]["k1_lse_bound_by"],
                 library_ms=tr["2b"]["sdpa_fwd_ms"], shape=tr["2b"]["shape"]),
            library_call=sdpa, lse_max_abs_err=fp16["worst"]["lse"],
            launches_per_step=steps[-1]["launches"]["k1_lse"],
            five_b={k: tr["5b"][k] for k in ("k1_lse_ms", "k1_lse_plain_ms",
                                             "k1_lse_bound_ms", "sdpa_fwd_ms", "shape")})]
    for name, key, line in (("flash_bwd_dq_f16", "k3a", 253),
                            ("flash_bwd_dkv_f16", "k3b", 290)):
        rows.append(row(
            name, bwd, f"dove_tpu/ops/pallas/flash_attention.py:{line}", recipe(key),
            fp16["worst"][key],
            dict(ms=tr["2b"][f"{key}_ms"], plain_ms=tr["2b"][f"{key}_plain_ms"],
                 bound_ms=tr["2b"][f"{key}_bound_ms"], bound_by=tr["2b"][f"{key}_bound_by"],
                 library_ms=tr["2b"]["sdpa_bwd_ms"], shape=tr["2b"]["shape"]),
            library_call="scaled_dot_product_attention forward plus backward minus its "
                         "forward, fp16: dq, dk and dv in one call",
            launches_per_step=steps[-1]["launches"][key],
            five_b={k: tr["5b"][k] for k in (f"{key}_ms", f"{key}_plain_ms",
                                             f"{key}_bound_ms", "sdpa_bwd_ms", "shape")}))
    conv = fp16["conv"]
    rows.append(row("conv3d_w8a8_f16_out", conv_src,
                    "dove_tpu/ops/pallas/conv3d_int8.py:244",
                    serving["vae_route"]["k4"] + serving["vae_route"]["k4_kt1"],
                    conv["k4"]["max_abs_err"], conv["k4"]))
    rows.append(row("conv3d_bf16_f16_out", conv_src,
                    "dove_tpu/ops/pallas/conv3d_int8.py:337", serving["vae_route"]["k5"],
                    conv["k5"]["max_abs_err"], conv["k5"],
                    library_call=conv["k5"]["library_call"]))
    rows.append(row("quant_pack_f16_in", "dove_tpu_torch/csrc/conv3d_taps.cu",
                    "dove_tpu/ops/quant.py:240 (the quantizer's fused elementwise "
                    "chain; not a Pallas kernel)", serving["vae_route"]["quantize"],
                    conv["quantizer"]["max_abs_err"], conv["quantizer"]))
    return rows


# ---------------------------------------------------------------------------
# Phase 30: parallel/ on torch.distributed
# ---------------------------------------------------------------------------

PARALLEL_DIR = "build/chip_smoke_parallel"
PROBE_OPS = ("all_reduce", "all_gather_into_tensor", "reduce_scatter_tensor", "broadcast")
TP_LAYERS, TP_STEP_LAYERS = 4, 2  # phase 30(c): the TP forward, the TP step
# the main path's DiT input: the 32-frame 180x320 clip padded to 33x192x320,
# 9 latents + 1 temporal pad, 96x160 latents: 19200 + 226 text tokens
TP_LATENT = (1, 10, 16, 96, 160)


def _spawn_ranks(kind: str, backend: str, world: int, timeout: float) -> list[dict]:
    """``world`` subprocesses of this script as the ranks of ``kind`` over
    ``backend``, every one on cuda:0, joined through a file rendezvous; each
    writes a JSON result. Raises if a rank fails or outlasts ``timeout``."""
    return _collect_ranks(_start_ranks(kind, backend, world), timeout)


def _start_ranks(kind: str, backend: str, world: int):
    """The ranks of _spawn_ranks, started; _collect_ranks waits for them."""
    import os

    os.makedirs(PARALLEL_DIR, exist_ok=True)
    init = os.path.abspath(f"{PARALLEL_DIR}/rdv_{kind}_{backend}_{time.time_ns()}")
    outs = [f"{PARALLEL_DIR}/{kind}_{backend}_{r}.json" for r in range(world)]
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--rank-body", kind, backend,
         str(r), str(world), init, outs[r]],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True) for r in range(world)]
    return kind, backend, procs, outs


def _collect_ranks(started, timeout: float) -> list[dict]:
    kind, backend, procs, outs = started
    logs = []
    try:
        deadline = time.perf_counter() + timeout
        for p in procs:
            logs.append(p.communicate(timeout=max(deadline - time.perf_counter(), 1))[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, text) in enumerate(zip(procs, logs)):
        if p.returncode:
            raise AssertionError(f"ranks of {kind} over {backend}: rank {r} exited "
                                 f"{p.returncode}:\n{text[-3000:]}")
    return [json.loads(open(o).read()) for o in outs]


def _probe_body(rank: int, world: int) -> dict:
    """Which collectives the backend takes on CUDA tensors, bf16 and fp32:
    "ok", "wrong" (ran, wrong values) or the error."""
    import torch.distributed as dist

    res = {}
    for dtype in (torch.bfloat16, torch.float32):
        for op in PROBE_OPS:
            x = torch.full((world * 4,), float(rank + 1), device="cuda", dtype=dtype)
            total = world * (world + 1) / 2
            try:
                if op == "all_reduce":
                    dist.all_reduce(x)
                    ok = bool((x == total).all())
                elif op == "all_gather_into_tensor":
                    out = torch.empty(world * x.numel(), device="cuda", dtype=dtype)
                    dist.all_gather_into_tensor(out, x)
                    want = torch.arange(1, world + 1, device="cuda", dtype=dtype)
                    ok = bool((out.view(world, -1) == want[:, None]).all())
                elif op == "reduce_scatter_tensor":
                    out = torch.empty(4, device="cuda", dtype=dtype)
                    dist.reduce_scatter_tensor(out, x)
                    ok = bool((out == total).all())
                else:
                    dist.broadcast(x, src=0)
                    ok = bool((x == 1).all())
                torch.cuda.synchronize()
                res[f"{op} {str(dtype)[6:]}"] = "ok" if ok else "wrong"
            except Exception as e:  # the backend refuses: recorded, not raised
                res[f"{op} {str(dtype)[6:]}"] = f"{type(e).__name__}: {str(e)[:100]}"
    return res


def _tp_body(rank: int, world: int) -> dict:
    """Phase 30(c) on one rank: the DiT at TP_LAYERS layers, full width,
    split over the ranks against its whole self (bf16 through K1, int8-dit
    through K2), then a TP stage-1 step at TP_STEP_LAYERS layers; rank 0
    holds the step to the one-process reference the parent wrote."""
    import dataclasses

    import torch.distributed as dist

    from dove_tpu_torch import cogvideox1_5_5b, init_dit_params
    from dove_tpu_torch.ops import flash_attention as fa
    from dove_tpu_torch.ops.quant import quantize_dit
    from dove_tpu_torch.parallel.tp import Group, shard_dit_tp
    from dove_tpu_torch.train.trainer import DOVES1Trainer

    base = cogvideox1_5_5b()
    cfg = dataclasses.replace(base.dit, num_layers=TP_LAYERS)
    g = Group(dist.group.WORLD, world, rank)
    gen = torch.Generator(device="cuda").manual_seed(30)
    z = torch.randn(TP_LATENT, generator=gen, device="cuda").to(torch.bfloat16)
    text = (torch.randn((1, cfg.max_text_seq_length, cfg.text_embed_dim), generator=gen,
                        device="cuda") * 0.1).to(torch.bfloat16)
    t = torch.full((1,), 399, device="cuda")
    res = {}
    for mode, backend, counter in (("bf16", "flash", fa.launches),
                                   ("int8-dit", "flash-qk8", fa.launches_qk8),
                                   ("sp", "flash", fa.launches)):
        dit = init_dit_params(cfg, seed=0, device="cuda", dtype=torch.bfloat16)
        if mode == "int8-dit":
            quantize_dit(dit)
        with torch.no_grad():
            ref = dit(z, text, t, attention_backend=backend, bounded_logits=True).float()
            # "sp": the ranks as "data" rows of a batch of 1, each taking a
            # slice of the tokens (sequence parallelism) with all 48 heads
            sp = g if mode == "sp" else None
            if sp is None:
                shard_dit_tp(dit, g)
            counter.reset()
            counter.shapes = []
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            out = dit(z, text, t, attention_backend=backend, bounded_logits=True,
                      sp=sp).float()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        mse = float((out - ref).square().mean())
        peak_sq = float(ref.abs().max()) ** 2
        res[mode] = dict(
            rel_err=float((out - ref).abs().max()) / float(ref.abs().max()),
            psnr_db=float("inf") if mse == 0 else 10 * math.log10(peak_sq / mse),
            launches=counter.count, shape=list(counter.shapes[0]), wall_s=wall,
            peak_gib=torch.cuda.max_memory_allocated() / 2**30)
        counter.shapes = None
        del dit, ref, out
        torch.cuda.empty_cache()

    # the TP stage-1 step: LoRA B off zero, one batch clip, as phase 10
    step_cfg = dataclasses.replace(base, dit=dataclasses.replace(base.dit,
                                                                 num_layers=TP_STEP_LAYERS))
    args = dataclasses.replace(_train_args(f"{PARALLEL_DIR}/tp_step"), tensor_parallel=world,
                               batch_size=1)
    tr = DOVES1Trainer(args, pipeline_config=step_cfg,
                       device=f"cuda:{torch.cuda.current_device()}")
    tr.load_components()
    _lora_b_off_zero(tr)
    batch = tr.device_batch(train_batch(seed=30, batch=1))
    counters = _k3_counters()
    for c in counters.values():
        c.reset()
    t0 = time.perf_counter()
    loss, _, grads = tr.loss_and_grads(batch)
    torch.cuda.synchronize()
    res["step"] = dict(loss=float(loss), wall_s=time.perf_counter() - t0,
                       launches={n: c.count for n, c in counters.items()},
                       peak_gib=torch.cuda.max_memory_allocated() / 2**30)
    if rank == 0:
        ref = _load_ref(f"{PARALLEL_DIR}/tp_step_ref.pt")
        res["step"]["ref_loss"] = ref["loss"]
        res["step"]["grad_rel_rms"] = {
            name: _rel_rms(gr, ref["grads"][i].to(gr.device))
            for i, (name, gr) in enumerate(zip(ref["names"], grads))}
    return res


def _save_ref(obj, path: str) -> None:
    """torch.save to ``path`` through a temporary name, so that a rank that
    waits for the file (_load_ref) reads it whole."""
    import os

    torch.save(obj, path + ".tmp")
    os.replace(path + ".tmp", path)


def _load_ref(path: str, timeout: float = 600.0):
    """The reference the parent writes while the ranks run (_save_ref)."""
    import os

    deadline = time.perf_counter() + timeout
    while not os.path.exists(path):
        if time.perf_counter() > deadline:
            raise TimeoutError(f"no reference at {path} after {timeout:.0f}s")
        time.sleep(0.5)
    return torch.load(path, weights_only=True)


def _lora_b_off_zero(tr) -> None:
    with torch.no_grad():  # so that the A gradients are not 0
        gen = torch.Generator(device="cuda").manual_seed(10)
        for ab in tr.lora_params.values():
            ab["B"].copy_(torch.randn(ab["B"].shape, generator=gen, device="cuda") * 1e-2)


def _tp_step_reference(world: int) -> dict:
    """The one-process counterpart of _tp_body's step, written for rank 0."""
    import dataclasses

    from dove_tpu_torch import cogvideox1_5_5b
    from dove_tpu_torch.train.trainer import DOVES1Trainer

    base = cogvideox1_5_5b()
    step_cfg = dataclasses.replace(base, dit=dataclasses.replace(base.dit,
                                                                 num_layers=TP_STEP_LAYERS))
    args = dataclasses.replace(_train_args(f"{PARALLEL_DIR}/tp_step"), batch_size=1)
    tr = DOVES1Trainer(args, pipeline_config=step_cfg, device="cuda")
    tr.load_components()
    _lora_b_off_zero(tr)
    loss, _, grads = tr.loss_and_grads(tr.device_batch(train_batch(seed=30, batch=1)))
    names = [f"{t}.{ab}" for t in tr.lora_params for ab in ("A", "B")]
    _save_ref({"loss": float(loss), "grads": [x.cpu() for x in grads], "names": names},
              f"{PARALLEL_DIR}/tp_step_ref.pt")
    del tr, grads
    torch.cuda.empty_cache()
    return dict(loss=float(loss))


def _tp_rows(parallel: dict, mode: str, key: str) -> list | None:
    """Phase 30(c)'s ``key`` of the TP DiT in ``mode``, one entry a rank."""
    return None if parallel["tp"] is None else [r[mode][key] for r in parallel["tp"]]


def _tp_step(parallel: dict, kernel: str) -> list | None:
    """Phase 30(c)'s launches of ``kernel`` in the TP step, one entry a rank."""
    return (None if parallel["tp"] is None
            else [r["step"]["launches"][kernel] for r in parallel["tp"]])


def _c7_launches(c7: dict, kernel: str) -> dict:
    """Phase 34's launches of ``kernel`` per layout, one entry a rank."""
    return {layout: [r[layout]["launches"][kernel] for r in c7["ranks"]]
            for layout in C7_LAYOUTS}


def rank_body(kind: str, backend: str, rank: int, world: int, init: str, out: str) -> int:
    """One rank of phase 30 or 34, started by _spawn_ranks."""
    import faulthandler

    import torch.distributed as dist

    faulthandler.enable()  # a crash prints the rank's Python stack

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.cuda.set_device(rank % torch.cuda.device_count())  # phase 30: all on one
    dist.init_process_group(backend, init_method=f"file://{init}", rank=rank,
                            world_size=world)
    try:
        res = {"probe": _probe_body, "tp": _tp_body, "c7": _c7_body}[kind](rank, world)
    finally:
        dist.destroy_process_group()
    with open(out, "w") as f:
        json.dump(res, f)
    return 0


def phase_parallel(main_out: np.ndarray, train_step1: dict) -> dict:
    """Phase 30: parallel/ on torch.distributed with one card.

    (a) the probe: two ranks over gloo and one over NCCL, all on the card:
        which collectives each backend takes on CUDA tensors;
    (b) world size 1 over NCCL, in this process: phase 4's staged clip
        through ``process_frames(mesh=make_mesh(1, 1))`` and phase 11's
        first stage-1 step at 42 layers under the initialised group, each
        equal to its run without a group, with their launches;
    (c) where gloo all-reduces CUDA tensors: two ranks sharing the card,
        the DiT at full width and TP_LAYERS layers split two ways (24 heads
        a rank) against the whole DiT in bf16 (K1) and int8-dit (K2), and
        token-sharded two ways (sequence parallelism, K1 on half the
        queries), at the kernel phases' bar (PSNR >= 40 dB or rel err <=
        2e-2), and a
        TP stage-1 step at TP_STEP_LAYERS layers against one process (loss
        1e-2, LoRA gradients 5e-2 RMS). One card shared by two ranks: a
        correctness run, not a speed-up."""
    import dataclasses
    import os

    import torch.distributed as dist

    from dove_tpu_torch import cogvideox1_5_5b, init_dit_params, init_vae_params
    from dove_tpu_torch.ops import flash_attention as fa
    from dove_tpu_torch.parallel.mesh import make_mesh
    from dove_tpu_torch.train.trainer import DOVES1Trainer

    t_phase = time.perf_counter()
    os.makedirs(PARALLEL_DIR, exist_ok=True)
    t0 = time.perf_counter()
    # (a) the two groups' ranks probe while (b) runs in this process
    probes = {b: _start_ranks("probe", b, n) for b, n in (("gloo", 2), ("nccl", 1))}

    # (b) world size 1 over NCCL
    init = os.path.abspath(f"{PARALLEL_DIR}/rdv_ws1_{time.time_ns()}")
    dist.init_process_group("nccl", init_method=f"file://{init}", rank=0, world_size=1)
    try:
        cfg = cogvideox1_5_5b()
        dit = init_dit_params(cfg.dit, seed=0, device="cuda", dtype=torch.bfloat16)
        vae = init_vae_params(cfg.vae, seed=1, device="cuda", dtype=torch.bfloat16)
        pipe = _pipeline(cfg, dit, vae, None, sample_posterior=True)
        clip = np.random.default_rng(4).uniform(
            0, 1, (CLIP_FRAMES, CLIP_H, CLIP_W, 3)).astype(np.float32)
        fa.launches.reset()
        t0 = time.perf_counter()
        out = pipe.process_frames(clip, seed=0, mesh=make_mesh(1, 1))
        clip_s = time.perf_counter() - t0
        clip_launches = fa.launches.count
        del pipe, dit, vae
        torch.cuda.empty_cache()
        if not np.array_equal(out, main_out) or clip_launches != cfg.dit.num_layers:
            raise AssertionError(
                f"phase 30(b): the meshed clip differs from phase 4's (max |diff| "
                f"{int(np.abs(out.astype(int) - main_out.astype(int)).max())}) or K1 "
                f"launched {clip_launches} times, want {cfg.dit.num_layers}")
        tr = DOVES1Trainer(_train_args(f"{PARALLEL_DIR}/ws1_train"), device="cuda")
        tr.load_components()
        tr.prepare_optimizer(TRAIN_STEPS)
        batch = tr.device_batch(train_batch(seed=11))
        counters = _k3_counters()
        for c in counters.values():
            c.reset()
        loss, _, gnorm = tr.train_step(batch)
        torch.cuda.synchronize()
        step_launches = {n: c.count for n, c in counters.items()}
        layers = tr.config.dit.num_layers
        want = {"k1": 0, "k1_lse": 2 * layers, "k2": 0, "k3a": layers, "k3b": layers}
        step = dict(loss=float(loss), grad_norm=float(gnorm), launches=step_launches,
                    mesh=dict(tr.mesh.shape))
        del tr, batch
        torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()
    probe = {b: _collect_ranks(st, 240)[0] for b, st in probes.items()}
    log(f"phase 30(a) collectives on CUDA tensors ({time.perf_counter() - t0:.1f}s, "
        f"beside (b)): {json.dumps(probe)}")
    if (step["loss"], step["grad_norm"]) != (train_step1["loss"], train_step1["grad_norm"]) \
            or step_launches != want:
        raise AssertionError(f"phase 30(b): the step under the group {step} differs from "
                             f"phase 11's first {train_step1}, or launches != {want}")
    log(f"phase 30(b) world size 1 over NCCL: the 42-layer staged clip through "
        f"make_mesh(1, 1) equal to phase 4's ({clip_s:.2f}s, K1 {clip_launches}); the "
        f"stage-1 step loss {step['loss']:.6f}, grad_norm {step['grad_norm']:.6e} equal "
        f"to phase 11's first, launches {step_launches}")

    # (c) two ranks sharing the card over gloo
    takes = all(probe["gloo"][f"all_reduce {d}"] == "ok" for d in ("bfloat16", "float32"))
    tp = None
    if takes:
        t0 = time.perf_counter()
        if os.path.exists(f"{PARALLEL_DIR}/tp_step_ref.pt"):
            os.remove(f"{PARALLEL_DIR}/tp_step_ref.pt")
        started = _start_ranks("tp", "gloo", 2)  # they start while the reference runs
        ref = _tp_step_reference(2)
        tp = _collect_ranks(started, 600)
        tp_s = time.perf_counter() - t0
        r0 = tp[0]
        worst = max(r0["step"]["grad_rel_rms"].values())
        loss_rel = abs(r0["step"]["loss"] - ref["loss"]) / abs(ref["loss"])
        want_step = {"k1": 0, "k1_lse": 2 * TP_STEP_LAYERS, "k2": 0,
                     "k3a": TP_STEP_LAYERS, "k3b": TP_STEP_LAYERS}
        heads = cfg.dit.num_attention_heads
        # TP: half the heads a rank, all the queries; SP: all the heads, half
        # the queries (19426 tokens, padded to 19426 + 0 over 2)
        want_q = {"bf16": [1, heads // 2, 19426], "int8-dit": [1, heads // 2, 19426],
                  "sp": [1, heads, 19426 // 2]}
        log(f"phase 30(c) two ranks on one card over gloo ({tp_s:.1f}s with the "
            f"one-process step): TP=2 and SP=2 DiT ({TP_LAYERS} layers, full width) vs "
            "whole " + json.dumps(rounded({m: r0[m] for m in ("bf16", "int8-dit", "sp")}, 6))
            + f"; TP step ({TP_STEP_LAYERS} layers, batch 1): loss {r0['step']['loss']:.6f} "
            f"vs {ref['loss']:.6f} (rel {loss_rel:.2e}), LoRA grad rms err "
            + json.dumps({k: float(f"{x:.2e}") for k, x in r0["step"]["grad_rel_rms"].items()})
            + f", launches {r0['step']['launches']}, wall {r0['step']['wall_s']:.2f}s, "
            f"peak {r0['step']['peak_gib']:.2f} GiB a rank")
        for r, res in enumerate(tp):
            for mode, q in want_q.items():
                m = res[mode]
                if not (m["psnr_db"] >= PSNR_BAR_DB or m["rel_err"] <= 2e-2) \
                        or m["launches"] != TP_LAYERS or m["shape"][:3] != q:
                    raise AssertionError(f"phase 30(c) rank {r} {mode}: {m}, want q {q}")
            if res["step"]["launches"] != want_step:
                raise AssertionError(f"phase 30(c) rank {r} step launches "
                                     f"{res['step']['launches']}, want {want_step}")
        if not loss_rel <= TRAIN_LOSS_REL_TOL or not worst <= TRAIN_GRAD_REL_RMS_TOL:
            raise AssertionError(f"phase 30(c) TP step: loss rel {loss_rel}, LoRA grads "
                                 f"{r0['step']['grad_rel_rms']}")
    else:
        log("phase 30(c) left out: gloo does not all-reduce CUDA tensors here "
            f"({probe['gloo']})")
    phase_s = time.perf_counter() - t_phase
    log(f"phase 30 took {phase_s:.1f}s")
    return dict(probe=probe, clip_launches=clip_launches, step=step, tp=tp,
                phase_s=phase_s)


# ---------------------------------------------------------------------------
# Phases 31-34: T5, the prompt path, flow fusion, whole-tensor optimizer
# statistics on split tensors
# ---------------------------------------------------------------------------

T5_TOKENS = 226
T5_WARMUP = 3
T5_REPS = 20
# T5-XXL in bf16 against the same seeded module in fp32 on the card: 24
# blocks of bf16 matmuls and residual adds, each rounding at ~2^-9
# relative; held relative to the fp32 output's RMS (and its largest value).
T5_REL_RMS_TOL = 3e-2
T5_REL_MAX_TOL = 5e-2
PROMPT = "a red cat runs in the snow"
PROMPT_WORDS = ("a", "red", "cat", "runs", "in", "the", "snow", "dog", "city", "car")
# phase 34: the SFT step's optimizers, their learning rates (AdamW's at one
# where each step moves a bf16 weight of ~0.02 by about eight ulps; Prodigy
# at its customary 1), and the bars of the sharded step against one device's
# optimizer on the same (gathered) gradient: every weight within one bf16 ulp
# and at most C7_DIFF_SHARE of them off (the clip's norm is summed in another
# order), every float statistic within C7_STATE_REL of its largest value
# (Prodigy's sums over the model are added in another order), at most
# C7_DIFF_SHARE of the block codes off
C7_OPTS = ("came", "prodigy", "adamw-8bit", "adamw-4bit")
# optimizer steps on the step's gradients: Prodigy's sums over the model
# are 0 on its first (no weight has moved from its start yet)
C7_STEPS = 2
C7_LR = {"came": 1e-3, "prodigy": 1.0, "adamw-8bit": 1e-3, "adamw-4bit": 1e-3}
C7_DIFF_SHARE = 1e-3
C7_STATE_REL = 1e-5
C7_LAYOUTS = ("tensor_parallel", "fsdp")


def _t5_reps(fn) -> dict:
    """T5's forward timed call by call: the median and range of T5_REPS
    calls, each between two CUDA events with the queue drained before it;
    the host's time to issue one call (no synchronisation inside the loop);
    and one call's device time when T5_REPS calls are queued back to back,
    which the host's issue rate bounds where it is the slower."""
    for _ in range(T5_WARMUP):
        fn()
    times = []
    for _ in range(T5_REPS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(T5_REPS):
        fn()
    host_ms = (time.perf_counter() - t0) * 1e3 / T5_REPS
    torch.cuda.synchronize()
    return dict(ms=statistics.median(times), ms_min=min(times), ms_max=max(times),
                host_ms=host_ms, queued_ms=cuda_ms(fn, reps=T5_REPS, warmup=0))


def phase_t5_xxl() -> dict:
    """Phase 31: T5-XXL (24 blocks, d_model 4096, 64 heads, d_ff 10240) on
    seeded weights built on the card, one 226-token id sequence from a
    seeded generator: bf16 time and peak, held to the same module in fp32
    (drawn from the same seed in fp32, so the bf16 weights are its rounding)."""
    from dove_tpu_torch.models.t5 import init_t5, t5_xxl

    cfg = t5_xxl()
    gen = torch.Generator(device="cuda").manual_seed(31)
    ids = torch.randint(0, cfg.vocab_size, (1, T5_TOKENS), generator=gen, device="cuda")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = init_t5(cfg, seed=31, dtype=torch.bfloat16, device="cuda")
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in model.parameters())
    weight_gib = sum(p.numel() * p.element_size() for p in model.parameters()) / 2**30
    with torch.no_grad():
        out = model(ids).float()
        reps = _t5_reps(lambda: model(ids))
    peak = torch.cuda.max_memory_allocated() / 2**30
    del model
    torch.cuda.empty_cache()
    ref_model = init_t5(cfg, seed=31, dtype=torch.float32, device="cuda")
    with torch.no_grad():
        ref = ref_model(ids)
        fp32_ms = cuda_ms(lambda: ref_model(ids), reps=2, warmup=0)
    del ref_model
    torch.cuda.empty_cache()
    err = attn_errors(out, ref)
    res = dict(params=n_params, weight_gib=weight_gib, build_s=build_s, **reps,
               fp32_ms=fp32_ms, peak_gib=peak, rel_rms=err["rel_rms"],
               rel_max=err["rel_max"], shape=list(out.shape))
    log(f"phase 31 T5-XXL ({n_params / 1e9:.3f} B parameters, {weight_gib:.2f} GiB in "
        f"bf16, built on the card in {build_s:.1f}s): {T5_TOKENS} tokens in {reps['ms']:.3f} "
        f"ms, the median of {T5_REPS} calls timed one by one by CUDA events after "
        f"{T5_WARMUP} warm-ups (range {reps['ms_min']:.3f}-{reps['ms_max']:.3f}; the host "
        f"issues a call in {reps['host_ms']:.3f} ms, its device time with the queue fed "
        f"{reps['queued_ms']:.3f} ms; fp32 {fp32_ms:.2f} ms), peak {peak:.2f} GiB; "
        f"bf16 against fp32: rel rms {err['rel_rms']:.2e} (bar {T5_REL_RMS_TOL}), rel max "
        f"{err['rel_max']:.2e} (bar {T5_REL_MAX_TOL})")
    if (res["shape"] != [1, T5_TOKENS, cfg.d_model] or not bool(torch.isfinite(out).all())
            or not err["rel_rms"] <= T5_REL_RMS_TOL or not err["rel_max"] <= T5_REL_MAX_TOL):
        raise AssertionError(f"phase 31: {res}")
    return res


def _write_prompt_model(root) -> dict:
    """A diffusers folder for the CLI: the 5B at full width and 2 layers with
    the seeded bf16 weights the CLI draws without --model_path at --seed 0
    (DiT seed 0, VAE seed 1), its VAE and scheduler, a one-block T5 at XXL's
    width as ``text_encoder/`` and a word-level ``tokenizer/``."""
    import dataclasses

    from tokenizers import Tokenizer, models, pre_tokenizers, processors

    from dove_tpu_torch import cogvideox1_5_5b, init_dit_params, init_vae_params
    from dove_tpu_torch import safetensors_io
    from dove_tpu_torch.models.t5 import hf_state_dict, init_t5, t5_xxl

    cfg = cogvideox1_5_5b()
    cfg = dataclasses.replace(cfg, dit=dataclasses.replace(cfg.dit, num_layers=2))
    for sub, name, conf in (("transformer", "config.json", cfg.dit),
                            ("vae", "config.json", cfg.vae),
                            ("scheduler", "scheduler_config.json", cfg.scheduler)):
        (root / sub).mkdir(parents=True)
        (root / sub / name).write_text(json.dumps(dataclasses.asdict(conf)))
    for sub, module in (("transformer", init_dit_params(cfg.dit, seed=0, device="cuda",
                                                        dtype=torch.bfloat16)),
                        ("vae", init_vae_params(cfg.vae, seed=1, device="cuda",
                                                dtype=torch.bfloat16))):
        safetensors_io.save_file({k: v.cpu() for k, v in module.state_dict().items()},
                                 root / sub / "diffusion_pytorch_model.safetensors")
        del module
    vocab = {"<pad>": 0, "</s>": 1, "<unk>": 2}
    vocab.update({w: i + 3 for i, w in enumerate(PROMPT_WORDS)})
    t5_cfg = dataclasses.replace(t5_xxl(), num_layers=1, vocab_size=len(vocab))
    (root / "text_encoder").mkdir()
    t5 = init_t5(t5_cfg, seed=32, dtype=torch.bfloat16, device="cuda")
    safetensors_io.save_file({k: v.cpu() for k, v in hf_state_dict(t5).items()},
                             root / "text_encoder" / "model.safetensors")
    (root / "text_encoder" / "config.json").write_text(json.dumps(dataclasses.asdict(t5_cfg)))
    del t5
    tok = Tokenizer(models.WordLevel(vocab, unk_token="<unk>"))
    tok.pre_tokenizer = pre_tokenizers.Whitespace()
    tok.post_processor = processors.TemplateProcessing(single="$A </s>",
                                                       special_tokens=[("</s>", 1)])
    (root / "tokenizer").mkdir()
    tok.save(str(root / "tokenizer" / "tokenizer.json"))
    (root / "tokenizer" / "tokenizer_config.json").write_text(json.dumps(
        {"tokenizer_class": "PreTrainedTokenizerFast", "pad_token": "<pad>",
         "eos_token": "</s>", "unk_token": "<unk>", "model_max_length": 512}))
    torch.cuda.empty_cache()
    return dict(layers=cfg.dit.num_layers, t5=dataclasses.asdict(t5_cfg))


def phase_prompt_cli() -> dict:
    """Phase 32: a non-empty prompt through ``python -m
    dove_tpu_torch.inference``: phase 24's two mp4 clips at 2 layers
    (--is_vae_st --png_save) from a model folder with phase 24's seeded
    weights, a T5 ``text_encoder/`` and its tokenizer; clip0 has a prompt,
    clip1 none. Against phase 24's PNG run (the same weights and flags, the
    empty prompt): clip0's frames differ, clip1's are equal (the default
    embedding came back). Needs phase 24's outputs; fails loudly where
    tokenizers or transformers does not import."""
    import shutil
    from pathlib import Path

    from dove_tpu_torch.inference import main as cli_main
    from dove_tpu_torch.io import video as video_io
    from dove_tpu_torch.ops import flash_attention as fa

    root = Path(VIDEO_DIR)
    if not (root / "png").is_dir():
        raise AssertionError(f"phase 32 needs phase 24's outputs under {root}")
    t0 = time.perf_counter()
    model = _write_prompt_model(root / "model")
    write_s = time.perf_counter() - t0
    (root / "prompts.json").write_text(json.dumps({"clip0": PROMPT}))
    argv = ["--input_dir", str(root / "in"), "--output_path", str(root / "prompt"),
            "--model_path", str(root / "model"), "--is_vae_st", "--png_save", "--seed", "0",
            "--input_json", str(root / "prompts.json")]
    fa.launches.reset()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    cli_main(argv)
    torch.cuda.synchronize()
    run = dict(wall_s=time.perf_counter() - t0, k1=fa.launches.count)
    frames = {(k, c): np.round(video_io.read_image_folder(root / k / c) * 255).astype(np.uint8)
              for k in ("prompt", "png") for c in ("clip0", "clip1")}
    res = dict(write_s=write_s, run=run,
               clip0_db=psnr_u8(frames["prompt", "clip0"], frames["png", "clip0"]),
               clip0_differs=bool(np.any(frames["prompt", "clip0"] != frames["png", "clip0"])),
               clip1_equal=bool(np.array_equal(frames["prompt", "clip1"],
                                               frames["png", "clip1"])))
    shutil.rmtree(root, ignore_errors=True)
    log(f"phase 32 prompt through the CLI (2 layers, T5 text_encoder of 1 block at "
        f"d_model {model['t5']['d_model']}, written in {write_s:.1f}s): {PROMPT!r} on "
        f"clip0, none on clip1: {json.dumps(rounded(run, 3))}; against phase 24's "
        f"empty-prompt run: clip0 {res['clip0_db']:.2f} dB (differs: "
        f"{res['clip0_differs']}), clip1 equal: {res['clip1_equal']}")
    want_k1 = model["layers"] * len(VIDEO_CLIPS)
    if not (res["clip0_differs"] and res["clip1_equal"]) or run["k1"] != want_k1:
        raise AssertionError(f"phase 32: {res}, want K1 {want_k1}")
    return res


def phase_flow_fusion() -> dict:
    """Phase 33: raft_bi_clip (seeded raft-things weights at full channels,
    20 iterations) on the main path's 32-frame 180x320 LQ clip (180 is no
    multiple of 8: resized to 184 and the flows back; windows of 25 frames
    sharing one); then on a latent-sized [1, 9, 90, 160, 16] tensor with the
    first 8 flows: optical_flow_feature, fusion_module_forward at init (the
    identity, exactly) and the learnable propagation_forward (mid_channels
    256, 16 deform groups). Times and peak memory."""
    from dove_tpu_torch.models import flow_fusion as ffm
    from dove_tpu_torch.models.raft import convert_raft

    def timed(fn):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, dict(s=time.perf_counter() - t0,
                         peak_gib=torch.cuda.max_memory_allocated() / 2**30)

    gen = torch.Generator().manual_seed(33)
    weights = convert_raft({k: v.numpy() for k, v in _raft_things_sd(gen).items()}, "cuda")
    clip = torch.from_numpy(np.random.default_rng(4).uniform(
        0, 1, (CLIP_FRAMES, CLIP_H, CLIP_W, 3)).astype(np.float32)).cuda()[None]
    with torch.no_grad():
        (fwd, bwd), raft = timed(lambda: ffm.raft_bi_clip(weights, clip))
        want = (1, CLIP_FRAMES - 1, CLIP_H, CLIP_W, 2)
        raft.update(shape=list(fwd.shape), max_px=float(torch.stack([fwd, bwd]).abs().max()))
        gen_c = torch.Generator(device="cuda").manual_seed(33)
        x = torch.randn((1, 9, 90, 160, 16), generator=gen_c, device="cuda")
        ff8, fb8 = fwd[:, :8].contiguous(), bwd[:, :8].contiguous()
        (back, forw), feature = timed(lambda: ffm.optical_flow_feature(x, ff8, fb8))
        fusion_p = ffm.init_fusion_module_params(16, seed=33, device="cuda")
        fused, fusion = timed(lambda: ffm.fusion_module_forward(fusion_p, x, back, forw))
        prop_p = ffm.init_propagation_params(16, seed=34, device="cuda")
        prop, propagation = timed(lambda: ffm.propagation_forward(prop_p, x, ff8, fb8))
    res = dict(raft=raft, feature=feature, fusion=fusion, propagation=propagation,
               fusion_identity=bool(torch.equal(fused, x)),
               finite=all(bool(torch.isfinite(t).all()) for t in (fwd, bwd, back, forw, prop)),
               prop_shape=list(prop.shape))
    del weights, clip, fwd, bwd, x, back, forw, fused, prop
    torch.cuda.empty_cache()
    log(f"phase 33 RAFT and flow fusion: raft_bi_clip on the {CLIP_FRAMES}x{CLIP_H}x{CLIP_W} "
        f"clip (20 iterations) {json.dumps(rounded(raft, 3))}; on [1, 9, 90, 160, 16]: "
        f"optical_flow_feature {json.dumps(rounded(feature, 3))}, fusion_module_forward "
        f"{json.dumps(rounded(fusion, 3))} (identity at init: {res['fusion_identity']}), "
        f"learnable propagation_forward (mid 256, 16 groups) "
        f"{json.dumps(rounded(propagation, 3))}; finite: {res['finite']}")
    if (raft["shape"] != list(want) or not res["finite"] or not res["fusion_identity"]
            or res["prop_shape"] != [1, 9, 90, 160, 16]):
        raise AssertionError(f"phase 33: {res}")
    return res


def _c7_args(layout: str | None, world: int, opt: str = "adamw"):
    """Phase 30(c)'s step (batch 1 of train_s1.sh's clip) under SFT, without
    warmup, over ``layout`` ("tensor_parallel" or "fsdp") or on one device."""
    import dataclasses

    kw = {layout: world} if layout else {}
    return dataclasses.replace(
        _train_args(f"{PARALLEL_DIR}/c7_{layout or 'one'}"), training_type="sft",
        batch_size=1, lr_warmup_steps=0, optimizer=opt, learning_rate=C7_LR.get(opt, 1e-3),
        **kw)


def _c7_config():
    import dataclasses

    from dove_tpu_torch import cogvideox1_5_5b

    base = cogvideox1_5_5b()
    return dataclasses.replace(base, dit=dataclasses.replace(base.dit,
                                                             num_layers=TP_STEP_LAYERS))


def _c7_reference() -> dict:
    """The one-process SFT step's loss and gradients, written for rank 0."""
    from dove_tpu_torch.train.trainer import DOVES1Trainer

    tr = DOVES1Trainer(_c7_args(None, 1), pipeline_config=_c7_config(), device="cuda")
    tr.load_components()
    loss, _, grads = tr.loss_and_grads(tr.device_batch(train_batch(seed=34, batch=1)))
    _save_ref({"loss": float(loss), "grads": [g.cpu() for g in grads]},
              f"{PARALLEL_DIR}/c7_ref.pt")
    del tr, grads
    torch.cuda.empty_cache()
    return dict(loss=float(loss))


def _ulp_bf16(x: torch.Tensor) -> torch.Tensor:
    """One bf16 ulp at each |x| (the smallest normal's where x is 0)."""
    e = torch.floor(torch.log2(x.float().abs().clamp_min(2.0 ** -126)))
    return torch.exp2(e - 7)


def _c7_body(rank: int, world: int) -> dict:
    """Phase 34 on one rank: per layout, the SFT step's forward and backward
    once (K1-lse, K3a, K3b on this rank's heads or the whole batch), the
    gradients gathered whole; then each optimizer of C7_OPTS from the same
    weights: C7_STEPS sharded steps on those gradients (train/optim.py with
    the trainer's splits), the updated weights and the state gathered
    whole. Rank 0 holds the loss and
    gradients to the one-process step, and the sharded step to one device's
    optimizer applied to the gathered gradient."""
    from dove_tpu_torch.train.optim import make_lr_schedule, make_optimizer
    from dove_tpu_torch.train.trainer import DOVES1Trainer, _local

    ref = None
    res = {}
    for layout in C7_LAYOUTS:
        tr = DOVES1Trainer(_c7_args(layout, world), pipeline_config=_c7_config(),
                           device=f"cuda:{torch.cuda.current_device()}")
        tr.load_components()
        log(f"  rank {rank} {layout}: components loaded")
        names = [n for n, _ in tr.dit.named_parameters()]
        splits = tr.trainable_splits()
        start = [_local(p).detach().clone() for p in tr.trainable_tensors()]
        w0 = {k: v.clone() for k, v in tr._trainable_state().items()}
        counters = _k3_counters()
        for c in counters.values():
            c.reset()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss, _, grads = tr.loss_and_grads(tr.device_batch(train_batch(seed=34, batch=1)))
        torch.cuda.synchronize()
        log(f"  rank {rank} {layout}: loss and gradients")
        row = dict(loss=float(loss), fwd_bwd_s=time.perf_counter() - t0,
                   launches={n: c.count for n, c in counters.items()},
                   split=sum(sp is not None for sp in splits), tensors=len(splits))
        whole = [g if sp is None else sp.gather(g) for g, sp in zip(grads, splits)]
        if rank == 0:
            ref = ref or _load_ref(f"{PARALLEL_DIR}/c7_ref.pt")
            row["ref_loss"] = ref["loss"]
            refs = [r.to(g.device).float() for g, r in zip(whole, ref["grads"])]
            diff = sum(float((g.float() - r).square().sum()) for g, r in zip(whole, refs))
            row["grad_rel_rms"] = math.sqrt(diff / sum(float(r.square().sum()) for r in refs))
            row["grad_worst_tensor_rel_rms"] = max(
                _rel_rms(g, r) for g, r in zip(whole, refs) if bool(r.any()))
            del refs
        row["opts"] = {}
        for opt in C7_OPTS:
            with torch.no_grad():
                for p, x in zip(tr.trainable_tensors(), start):
                    _local(p).copy_(x)
            tr.optimizer = None
            torch.cuda.empty_cache()
            tr.args.optimizer, tr.args.learning_rate = opt, C7_LR[opt]
            tr.prepare_optimizer(1)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(C7_STEPS):
                gnorm = tr.optimizer.step([_local(p) for p in tr.trainable_tensors()], grads)
            torch.cuda.synchronize()
            step_s = (time.perf_counter() - t0) / C7_STEPS
            log(f"  rank {rank} {layout} {opt}: stepped in {step_s:.2f}s")
            w1 = tr._trainable_state()
            state = tr.optimizer.map_shards(tr.optimizer.state_dict(),
                                            lambda sp, t: sp.gather(t))
            if rank != 0:
                continue
            args = tr.args
            lr = make_lr_schedule(args.learning_rate, warmup_steps=0, total_steps=1,
                                  kind=args.lr_scheduler)
            one = make_optimizer(opt, lr, betas=(args.beta1, args.beta2), beta3=args.beta3,
                                 eps=args.epsilon, weight_decay=args.weight_decay,
                                 max_grad_norm=args.max_grad_norm)
            params = [w0[n].clone() for n in names]
            one.init(params)
            for _ in range(C7_STEPS):
                one_norm = one.step(params, whole)
            off, worst_ulps, moved = 0, 0.0, 0
            for n, p in zip(names, params):
                d = (w1[n].float() - p.float()).abs()
                off += int((d > 0).sum())
                worst_ulps = max(worst_ulps, float((d / _ulp_bf16(p)).max()))
                moved += int((p != w0[n]).sum())
            n_el = sum(p.numel() for p in params)
            state_rel, code_off, codes = 0.0, 0, 0
            for key, want in one.state_dict().items():
                got = state[key]
                for a, b in zip(got if isinstance(got, list) else [got],
                                want if isinstance(want, list) else [want]):
                    if not isinstance(b, torch.Tensor):
                        continue
                    if b.dtype in (torch.uint8, torch.int8):
                        code_off += int((a != b).sum())
                        codes += b.numel()
                    elif b.numel():
                        scale = float(b.float().abs().max()) or 1.0
                        state_rel = max(state_rel,
                                        float((a.float() - b.float()).abs().max()) / scale)
            row["opts"][opt] = dict(
                step_s=step_s, grad_norm=float(gnorm), one_grad_norm=float(one_norm),
                weights_off_share=off / n_el, worst_ulps=worst_ulps, moved_share=moved / n_el,
                state_rel=state_rel, codes_off_share=code_off / codes if codes else 0.0,
                state_gib=tr.optimizer.state_bytes() / 2**30)
        res[layout] = row
        tr.optimizer = None
        del tr, grads, whole, start, w0
        torch.cuda.empty_cache()
    res["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    return res


def phase_c7() -> dict:
    """Phase 34 (ROADMAP C.7): two gloo ranks sharing the card, the SFT
    stage-1 step at full width and TP_STEP_LAYERS layers (phase 30(c)'s
    setting, batch 1) under tensor_parallel=2 and under fsdp=2, with CAME,
    Prodigy, 8-bit and 4-bit AdamW: the loss within 1e-2 and the gradient
    within 5e-2 RMS of the one-process step's (phase 30(c)'s bars); two
    sharded optimizer steps on it held to one device's optimizer on the
    gathered gradient (C7_* bars); K1-lse, K3a and K3b launched per rank as one
    process launches them."""
    import os

    os.makedirs(PARALLEL_DIR, exist_ok=True)
    if os.path.exists(f"{PARALLEL_DIR}/c7_ref.pt"):
        os.remove(f"{PARALLEL_DIR}/c7_ref.pt")
    t0 = time.perf_counter()
    started = _start_ranks("c7", "gloo", 2)  # they start while the reference runs
    ref = _c7_reference()
    ranks = _collect_ranks(started, 900)
    wall = time.perf_counter() - t0
    r0 = ranks[0]
    layers = TP_STEP_LAYERS
    want = {"k1": 0, "k1_lse": 2 * layers, "k2": 0, "k3a": layers, "k3b": layers}
    log(f"phase 34 C.7: SFT step at {layers} layers, full width, two gloo ranks on the "
        f"card ({wall:.1f}s with the one-process step; loss {ref['loss']:.6f}): "
        + json.dumps(rounded({k: v for k, v in r0.items()}, 6)))
    for r, res in enumerate(ranks):
        for layout in C7_LAYOUTS:
            if res[layout]["launches"] != want:
                raise AssertionError(f"phase 34 rank {r} {layout}: launches "
                                     f"{res[layout]['launches']}, want {want}")
    for layout in C7_LAYOUTS:
        row = r0[layout]
        loss_rel = abs(row["loss"] - row["ref_loss"]) / abs(row["ref_loss"])
        if not loss_rel <= TRAIN_LOSS_REL_TOL or not row["grad_rel_rms"] <= TRAIN_GRAD_REL_RMS_TOL:
            raise AssertionError(f"phase 34 {layout}: loss rel {loss_rel}, worst gradient "
                                 f"rel rms {row['grad_rel_rms']}")
        for opt, o in row["opts"].items():
            if (o["worst_ulps"] > 1.0 or o["weights_off_share"] > C7_DIFF_SHARE
                    or o["state_rel"] > C7_STATE_REL or o["codes_off_share"] > C7_DIFF_SHARE):
                raise AssertionError(f"phase 34 {layout} {opt}: {o}")
    return dict(ranks=ranks, ref=ref, wall_s=wall)


# ---------------------------------------------------------------------------
# Phase 35: the VAE's fused GroupNorm
# ---------------------------------------------------------------------------

# the bf16 decode plan's finest window (26 x 25 latents of 9 frames, 33
# frames of 208 x 200 at up.3) and the encode plan's first level (26 x 29)
GN_DEC_SHAPE, GN_DEC_LATENT = (1, 128, 33, 208, 200), (1, 16, 9, 26, 25)
GN_ENC_SHAPE = (1, 128, 33, 208, 232)


def _kernel_device_ms(fn, reps: int, names: tuple[str, ...]) -> dict[str, float]:
    """Device milliseconds a call of each kernel whose name holds one of
    ``names``, from a torch.profiler trace of ``reps`` calls."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out = {n: 0.0 for n in names}
    for evt in prof.key_averages():
        for n in names:
            if n in evt.key:
                out[n] += evt.device_time_total / 1e3 / reps
    return out


def phase_group_norm() -> dict:
    """Phase 35: the fused GroupNorm pair against its float32 plain version
    at the decoder's finest window (with the modulation) and the encoder's
    (without), timed beside its bytes bounds and the library route."""
    import torch.nn.functional as F

    from dove_tpu_torch.models import vae as tvae
    from dove_tpu_torch.ops import group_norm as gn

    gen = torch.Generator(device="cuda").manual_seed(35)
    rows = {}
    for name, shape, latent in (("decoder", GN_DEC_SHAPE, GN_DEC_LATENT),
                                ("encoder", GN_ENC_SHAPE, None)):
        C = shape[1]
        x = (torch.randn(shape, generator=gen, device="cuda") * 2 + 3).to(torch.bfloat16)
        w = (torch.rand(C, generator=gen, device="cuda") + 0.5).to(torch.bfloat16)
        b = (torch.randn(C, generator=gen, device="cuda") * 0.5).to(torch.bfloat16)
        cy = cb = None
        if latent is not None:
            lat = (1, C) + latent[2:]
            cy = (torch.randn(lat, generator=gen, device="cuda") * 0.5 + 1).to(torch.bfloat16)
            cb = (torch.randn(lat, generator=gen, device="cuda") * 0.5).to(torch.bfloat16)
        norm = torch.nn.GroupNorm(32, C, 1e-6, device="cuda", dtype=torch.bfloat16)
        norm.weight.data.copy_(w)
        norm.bias.data.copy_(b)

        def kernel():
            return gn.group_norm_silu_launch(x, 32, w, b, 1e-6, cy, cb, True)

        def plain():
            return gn.group_norm_silu_plain(x, 32, w, b, 1e-6, cy, cb, True)

        def library():
            y = tvae._group_norm(norm, x)
            if cy is not None:
                Fr, H, W = shape[2:]
                y = (y * tvae._nearest_resize_causal(cy, Fr, H, W, True)
                     + tvae._nearest_resize_causal(cb, Fr, H, W, True))
            return F.silu(y)

        out = kernel()
        torch.cuda.synchronize()
        ref = gn.group_norm_silu_plain(x.float(), 32, w.float(), b.float(), 1e-6,
                                       None if cy is None else cy.float(),
                                       None if cb is None else cb.float(), True)
        err = (out.float() - ref).abs()
        worst = float((err / (ref.abs() + 1e-3)).max())
        if not bool((err <= 2.0 ** -8 * ref.abs() + 2e-5 * float(ref.abs().max())).all()):
            raise AssertionError(f"phase 35 {name}: the kernel is off its plain version "
                                 f"(worst relative error {worst})")
        if not torch.equal(out, kernel()):
            raise AssertionError(f"phase 35 {name}: two runs differ")
        lib_err = float((library().float() - ref).abs().max())
        del out, ref, err
        n = x.numel()
        extra = 0 if cy is None else 2 * cy.numel() * 2
        split = _kernel_device_ms(kernel, 5, ("group_norm_stats_kernel",
                                              "group_norm_apply_kernel"))
        row = dict(
            shape=list(shape), latent=None if latent is None else list(latent),
            splits=gn.splits(shape[0] * 32, n // 32, 2,
                             torch.cuda.get_device_properties(0).multi_processor_count),
            worst_rel_err=worst, library_max_abs_err=lib_err,
            ms=cuda_ms(kernel, 10), stats_ms=split["group_norm_stats_kernel"],
            apply_ms=split["group_norm_apply_kernel"],
            plain_ms=cuda_ms(plain, 3), library_ms=cuda_ms(library, 10),
            bound_ms=(2 * n * 2 + extra) / PEAK_BYTES * 1e3,
            bound_r2w1_ms=(3 * n * 2 + extra) / PEAK_BYTES * 1e3, bound_by="bytes",
            stats_bound_ms=n * 2 / PEAK_BYTES * 1e3,
            apply_bound_ms=(2 * n * 2 + extra) / PEAK_BYTES * 1e3)
        row["hbm_share_r2w1"] = row["bound_r2w1_ms"] / row["ms"]
        row["channels_last"] = _group_norm_cl(x, w, b, cy, cb, n, extra)
        rows[name] = row
        del x, cy, cb
        torch.cuda.empty_cache()
    gn.launches.reset()
    log("phase 35 fused GroupNorm (bf16): " + json.dumps(rounded(rows, 5)))
    return rows


def _group_norm_cl(x, w, b, cy, cb, n: int, extra: int) -> dict:
    """Phase 35's channels-last form at x's shape: held to its plain version
    with two left frames of frame 0 in front, timed with its three kernels
    apart, and a norm site with its 3x3x3 causal conv both ways."""
    import torch.nn.functional as F

    from dove_tpu_torch.ops import group_norm as gn

    lead = 2
    C, Fr, H, W = x.shape[1:]
    xc = x.contiguous(memory_format=torch.channels_last_3d)
    cyc, cbc = ((None, None) if cy is None else
                (t.contiguous(memory_format=torch.channels_last_3d) for t in (cy, cb)))

    def kernel():
        return gn.group_norm_silu_launch(xc, 32, w, b, 1e-6, cyc, cbc, True, lead)

    out = kernel()
    torch.cuda.synchronize()
    ref = gn.group_norm_silu_cl_plain(xc.float(), 32, w.float(), b.float(), 1e-6,
                                      None if cy is None else cy.float(),
                                      None if cb is None else cb.float(), True, lead)
    err = (out.float() - ref).abs()
    worst = float((err / (ref.abs() + 1e-3)).max())
    if not bool((err <= 2.0 ** -8 * ref.abs() + 2e-5 * float(ref.abs().max())).all()):
        raise AssertionError(f"phase 35 channels-last: the kernel is off its plain version "
                             f"(worst relative error {worst})")
    front = out[:, :, lead:lead + 1].expand(-1, -1, lead, -1, -1)
    if not (gn.channels_last(out) and torch.equal(out, kernel())
            and torch.equal(out[:, :, :lead], front)):
        raise AssertionError("phase 35 channels-last: layout, left frames or two runs differ")
    del ref, err
    names = ("group_norm_stats_cl", "group_norm_finalize_cl", "group_norm_apply_cl")
    split = _kernel_device_ms(kernel, 5, names)
    conv = torch.nn.Conv3d(C, C, 3, device="cuda", dtype=x.dtype)
    w_cl = conv.weight.detach().contiguous(memory_format=torch.channels_last_3d)
    w_nc = conv.weight.detach().contiguous()

    def cl_site():  # the kernel writes the conv's input, left frames in place
        return F.conv3d(kernel(), w_cl, conv.bias, padding=(0, 1, 1))

    def replaced_site():  # x.contiguous(), the NCDHW pair, torch.cat, cuDNN NCDHW
        y = gn.group_norm_silu_launch(xc.contiguous(), 32, w, b, 1e-6, cy, cb, True)
        y = torch.cat([y[:, :, :1].expand(-1, -1, lead, -1, -1), y], dim=2)
        return F.conv3d(y, w_nc, conv.bias, padding=(0, 1, 1))

    site_err = float((cl_site().float() - replaced_site().float()).abs().max())
    written = n * (Fr + lead) // Fr
    bound = (2 * n + written) * 2 + extra
    row = dict(worst_rel_err=worst, ms=cuda_ms(kernel, 10),
               **{k.replace("group_norm_", "") + "_ms": v for k, v in split.items()},
               bound_r2w1_ms=bound / PEAK_BYTES * 1e3,
               site_ms=cuda_ms(cl_site, 5), replaced_site_ms=cuda_ms(replaced_site, 5),
               site_max_abs_diff=site_err)
    row["hbm_share_r2w1"] = row["bound_r2w1_ms"] / row["ms"]
    del out, conv
    return row


# ---------------------------------------------------------------------------
# Phase 36: K1 at head dim 128
# ---------------------------------------------------------------------------

# K1 d128's tiles are 128 queries and 128 keys; Wan's cross-attention has 512
D128_RAGGED = (1, 63, 64, 65, 127, 128, 129, 255, 256, 257, 512, 4097)
# Wan2.1-14B at the 32x180x320 clip: 40 heads, 9 x 48 x 80 video tokens, 512
# text slots
WAN_HEADS, WAN_TOKENS, WAN_TEXT = 40, 34560, 512


def k1_d128_edge_cases() -> dict:
    """K1 d128 against its plain version at every (Sq, Skv) of D128_RAGGED,
    B*H = 3, and with the neighbouring heads' q, k and v NaN."""
    from dove_tpu_torch.ops import flash_attention as fa

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(36)
    worst = dict(max_abs=0.0, rel_max=0.0, rel_rms=0.0)

    def rand(s):
        return torch.randn((1, 3, s, 128), generator=gen, device=dev, dtype=torch.bfloat16)

    def check(out, ref, what):
        err = attn_errors(out, ref)
        if not bool(torch.isfinite(out).all()) or not within_bars(err):
            raise AssertionError(f"K1 d128 disagrees with its plain version at {what}: {err}")
        for key in worst:
            worst[key] = max(worst[key], err[key])

    for sq in D128_RAGGED:
        for skv in D128_RAGGED:
            q, k, v = rand(sq), rand(skv), rand(skv)
            out = fa.flash_attention(q, k, v)
            torch.cuda.synchronize()
            check(out, fa.flash_attention_plain(q, k, v), f"sq={sq} skv={skv}")
    for sq, skv in ((129, 193), (4097, 129), (300, 512)):
        q, k, v = rand(sq), rand(skv), rand(skv)
        for t in (q, k, v):
            t[:, 0::2] = float("nan")
        out = fa.flash_attention(q, k, v)
        torch.cuda.synchronize()
        if not bool(torch.isnan(out[:, 0::2].float()).all()):
            raise AssertionError(f"K1 d128 wrote into a NaN head's output at sq={sq}")
        mid = [t[:, 1:2].contiguous() for t in (q, k, v)]
        check(out[:, 1:2], fa.flash_attention_plain(*mid), f"NaN neighbours sq={sq} skv={skv}")
    log(f"  K1 d128 at every Sq, Skv in {D128_RAGGED} (B*H = 3) and beside NaN heads: "
        f"{len(D128_RAGGED) ** 2 + 3} launches within the bars; worst "
        + json.dumps({k: float(f"{x:.3e}") for k, x in worst.items()}))
    return worst


def phase_k1_d128() -> dict:
    """Phase 36: K1 at head dim 128 at Wan2.1-14B's two attention shapes."""
    from dove_tpu_torch.ops import flash_attention as fa

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(360)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    rows = {}
    for name, sq, skv in (("self", WAN_TOKENS, WAN_TOKENS), ("cross", WAN_TOKENS, WAN_TEXT)):
        q, k, v = (torch.randn((1, WAN_HEADS, s, 128), generator=gen, device=dev,
                               dtype=torch.bfloat16) for s in (sq, skv, skv))
        errs = {}
        # unit-variance rows, and rows whose logits reach Wan's |q| |k| / sqrt(D)
        # scale (an RMS norm over 5120 channels lets one head hold them all)
        for label, gain in (("unit", 1.0), ("wide", 16.0)):
            qg = (q.float() * gain).to(torch.bfloat16)
            out = fa.flash_attention(qg, k, v)
            torch.cuda.synchronize()
            ref = fa.flash_attention_plain(qg, k, v)
            errs[label] = attn_errors(out, ref)
            # the wide rows' outputs are single values of v (|o| up to ~5.6),
            # where one bf16 ulp is 0.03125: the absolute bar scales with the
            # largest value past 1, as for a gradient
            ok = within_bars if label == "unit" else within_grad_bars
            if not bool(torch.isfinite(out).all()) or not ok(errs[label]):
                raise AssertionError(f"K1 d128 {name} {label}: {errs[label]}")
            del out, ref, qg
        if name == "self":
            dropped = fa.flash_attention_plain(q, k[:, :, 64:].contiguous(),
                                               v[:, :, 64:].contiguous())
            miss = attn_errors(dropped, fa.flash_attention_plain(q, k, v))
            if within_bars(miss):
                raise AssertionError(f"K1 d128 bars accept a dropped KV tile: {miss}")
            log(f"  bar check: one 64-key tile dropped at S={sq} gives rms err / rms ref "
                f"{miss['rel_rms']:.3e}, rejected")
            del dropped
        scale = 128 ** -0.5
        sdpa_before = cuda_ms(lambda: sdpa(q, k, v), 10)
        ms = cuda_ms(lambda: fa.flash_fwd_launch(q, k, v, scale, False, False), 10)
        clock = sm_clock_mhz()
        sdpa_ms = min(sdpa_before, cuda_ms(lambda: sdpa(q, k, v), 10))
        plain_ms = cuda_ms(lambda: fa.flash_attention_plain(q, k, v), 1, warmup=0)
        flops = 4.0 * sq * skv * 128 * WAN_HEADS
        nbytes = 2 * WAN_HEADS * 128 * 2 * (sq + skv)
        bound_ms = max(flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES) * 1e3
        sms = torch.cuda.get_device_properties(0).multi_processor_count
        rows[name] = dict(
            shape=[1, WAN_HEADS, sq, skv, 128], ms=ms, plain_ms=plain_ms, sdpa_ms=sdpa_ms,
            sdpa_ratio=ms / sdpa_ms, bound_ms=bound_ms,
            bound_by="operations" if flops / PEAK_BF16_FLOPS >= nbytes / PEAK_BYTES
            else "bytes", roofline_pct=100 * bound_ms / ms, tflops=flops / ms / 1e9,
            exp_floor_ms=float(sq) * skv * WAN_HEADS / (16 * sms * clock * 1e6) * 1e3,
            sm_clock_mhz=clock, errors=errs)
        log(f"  K1 d128 {name}: " + json.dumps(rounded(rows[name])))
        del q, k, v
    rows["edges"] = k1_d128_edge_cases()
    fa.launches.reset()
    log("phase 36 K1 d128: " + json.dumps(rounded(
        {n: {k: r[k] for k in ("ms", "bound_ms", "roofline_pct", "sdpa_ms", "plain_ms")}
         for n, r in rows.items() if n != "edges"})))
    return rows


def main(argv: list[str] | None = None) -> int:
    import argparse

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument(
        "--profile", metavar="DIR", default=None,
        help="after phases 4, 7, 11, 14 and 17, time a warm run and profile "
             "one more; write the top kernels to DIR/main_path_profile.txt, "
             "DIR/int8_main_path_profile.txt, DIR/train_step_profile.txt, "
             "DIR/int8_dit_dec_main_path_profile.txt and "
             "DIR/s2_train_step_profile.txt")
    parser.add_argument("--rank-body", nargs=6, default=None, help=argparse.SUPPRESS)
    parser.add_argument(
        "--phases", metavar="N,N", default=None,
        help="development: run only these phases (after the build) and print "
             "no result line; 28 runs 4 first, for its bf16 clip")
    args = parser.parse_args(argv)
    t_start = time.perf_counter()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing to run", file=sys.stderr)
        return 1
    if args.rank_body is not None:  # one rank of phase 30
        kind, backend, rank, world, init, out = args.rank_body
        return rank_body(kind, backend, int(rank), int(world), init, out)
    from dove_tpu_torch import cogvideox1_5_5b, cogvideox_2b

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = gpu_name_and_limit()
    log(f"phase 1 device: {card}; torch {torch.__version__} cuda "
        f"{torch.version.cuda}")
    phase_build()
    cfg = cogvideox1_5_5b()
    seq, heads = main_path_seq_len(cfg), cfg.dit.num_attention_heads
    seq_s2 = stage2_seq_len(cfg)
    cfg_2b = cogvideox_2b()
    shapes_2b = (main_path_seq_len(cfg_2b), cfg_2b.dit.num_attention_heads,
                 train_seq_len(cfg_2b))
    if args.phases is not None:
        # a development run of some phases: no kernels line, no ok line
        chosen = {int(p) for p in args.phases.split(",")}
        for numbers, run in (
                ({2}, lambda: phase_k1(seq, heads)),
                ({3}, phase_kernel_vs_plain_pipeline),
                ({4}, lambda: phase_main_path(args.profile)),
                ({5}, lambda: phase_k2(seq, heads)),
                ({6}, phase_k2_pipeline),
                ({7, 8}, lambda: phase_int8_paths(args.profile)),
                ({9}, lambda: phase_k3(heads, seq_s2)),
                ({10}, phase_train_kernel_vs_plain),
                ({11}, lambda: phase_train_recipe(args.profile)),
                ({12}, phase_conv_kernels),
                ({13}, phase_k4_pipeline),
                ({14}, lambda: phase_int8_dit_dec(args.profile)),
                ({15}, phase_hand_conv),
                ({16}, phase_s2_kernel_vs_plain),
                ({17}, lambda: phase_s2_recipe(args.profile)),
                ({18}, phase_fused_kernel_vs_plain),
                ({19, 20, 21}, phases_fused_and_scoring),
                ({22, 23}, lambda: phase_train_entry_point(phase_data_pipeline())),
                ({24}, phase_video_files),
                ({25}, lambda: phase_int8_drift(card)),
                ({26}, lambda: phase_optimizers(prepare_data_dir())),
                ({27}, lambda: phase_fp16_kernels(seq, heads, *shapes_2b)),
                ({28}, lambda: phase_2b_serving(phase_main_path()["out"])),
                ({29}, phase_fp16_training),
                ({30}, lambda: phase_parallel(phase_main_path()["out"],
                                              phase_train_recipe()["steps"][0])),
                ({31}, phase_t5_xxl),
                ({32}, lambda: (phase_video_files(), phase_prompt_cli())),
                ({33}, phase_flow_fusion),
                ({34}, phase_c7),
                ({35}, phase_group_norm),
                ({36}, phase_k1_d128)):
            if numbers & chosen:
                t0 = time.perf_counter()
                run()
                log(f"  (phase {min(numbers)} took {time.perf_counter() - t0:.1f}s)")
        log(f"partial run of phases {sorted(chosen)} on {card}: no result line")
        log(f"all chosen phases took {time.perf_counter() - t_start:.1f}s")
        return 0
    phase_s = {}

    def timed(label: str, fn, *a):
        t0 = time.perf_counter()
        out = fn(*a)
        phase_s[label] = round(time.perf_counter() - t0, 1)
        log(f"  (phase {label} took {phase_s[label]}s)")
        return out

    k1 = timed("2", phase_k1, seq, heads)
    timed("3", phase_kernel_vs_plain_pipeline)
    main_path = timed("4", phase_main_path, args.profile)
    k2 = timed("5", phase_k2, seq, heads)
    timed("6", phase_k2_pipeline)
    int8_main, streamed = timed("7-8", phase_int8_paths, args.profile)
    k3 = timed("9", phase_k3, heads, seq_s2)
    timed("10", phase_train_kernel_vs_plain)
    train = timed("11", phase_train_recipe, args.profile)
    k4, k5, quantizer = timed("12", phase_conv_kernels)
    timed("13", phase_k4_pipeline)
    dit_dec = timed("14", phase_int8_dit_dec, args.profile)
    hand = timed("15", phase_hand_conv)
    timed("16", phase_s2_kernel_vs_plain)
    s2 = timed("17", phase_s2_recipe, args.profile)
    fused_2l = timed("18", phase_fused_kernel_vs_plain)
    fused, _ = timed("19-21", phases_fused_and_scoring)
    data = timed("22", phase_data_pipeline)
    fit = timed("23", phase_train_entry_point, data)
    video = timed("24", phase_video_files)
    drift = timed("25", phase_int8_drift, card)
    opt = timed("26", phase_optimizers, data)
    fp16 = timed("27", phase_fp16_kernels, seq, heads, *shapes_2b)
    main_out = main_path.pop("out")
    serving_2b = timed("28", phase_2b_serving, main_out)
    training_2b = timed("29", phase_fp16_training)
    parallel = timed("30", phase_parallel, main_out, train["steps"][0])
    del main_out
    timed("31", phase_t5_xxl)
    timed("32", phase_prompt_cli)
    timed("33", phase_flow_fusion)
    c7 = timed("34", phase_c7)
    norm = timed("35", phase_group_norm)
    d128 = timed("36", phase_k1_d128)
    log(f"seconds by phase: {json.dumps(phase_s)}")
    log(f"all phases took {time.perf_counter() - t_start:.1f}s")

    kernels = [{
        "name": "flash_fwd_bf16",
        "route": "cuda",
        "source": "dove_tpu_torch/csrc/flash_fwd_sm90.cu",
        "replaces": "dove_tpu/ops/pallas/flash_attention.py:75",
        "launches": main_path["launches"],
        "max_abs_err": k1["max_abs_err"],
        "ms": k1["kernel_ms"],
        "plain_ms": k1["plain_ms"],
        "bound_ms": k1["bound_ms"],
        "bound_by": k1["bound_by"],
        "library_ms": k1["library_ms"],
        "forms_ms": k1["forms_ms"],
        "library_ratio": k1["sdpa_ratio"],
        # the fused outer-tile path: phase 19's clip at 42 layers, and phase
        # 18's 2-layer clip whose passes are all under 2048 tokens; calls and
        # tokens as measured (sr_tile's calls, the q shapes K1 launched at)
        "fused_launches": fused["warm"]["k1"],
        "fused_calls": fused["warm"]["calls"],
        "fused_tokens": [fused["warm"]["min_tokens"], fused["warm"]["max_tokens"]],
        "fused_max_abs_err": fused["held_worst"]["k1"],
        "fused_2l_launches": fused_2l["bf16"]["k1"],
        "fused_2l_calls": fused_2l["bf16"]["calls"],
        "fused_2l_tokens": fused_2l["bf16"]["tokens"],
        "exp_floor_ms": k1["exp_floor_ms"],
        "sm_clock_mhz": k1["sm_clock_mhz"],
        # the training form, with the logsumexp, at the stage-1 shape
        "lse_shape": k3["shape"],
        "lse_launches": train["launches"]["k1_lse"],
        "lse_launches_per_step": train["launches"]["k1_lse"] // TRAIN_STEPS,
        "lse_max_abs_err": k3["worst"]["k1_lse"],
        "lse_max_abs_err_lse": k3["worst"]["lse"],
        "lse_ms": k3["k1_lse_ms"],
        "lse_online_no_lse_ms": k3["k1_online_ms"],
        "lse_plain_ms": k3["k1_lse_plain_ms"],
        "lse_bound_ms": k3["k1_lse_bound_ms"],
        "lse_bound_by": k3["k1_lse_bound_by"],
        "lse_library_ms": k3["sdpa_fwd_ms"],
        "lse_forms_ms": k3["k1_forms"]["forms_ms"],
        "lse_library_ratio": k3["k1_forms"]["sdpa_ratio"],
        "lse_exp_floor_ms": k3["k1_forms"]["exp_floor_ms"],
        # the same form at the stage-2 shape, and its launches in phase 17
        "s2_shape": k3["stage2"]["shape"],
        "s2_lse_launches": s2["launches"]["k1_lse"],
        "s2_lse_launches_per_step": s2["launches"]["k1_lse"] // S2_STEPS,
        "s2_lse_ms": k3["stage2"]["k1_lse_ms"],
        "s2_lse_plain_ms": k3["stage2"]["k1_lse_plain_ms"],
        "s2_lse_bound_ms": k3["stage2"]["k1_lse_bound_ms"],
        "s2_lse_bound_by": k3["stage2"]["k1_lse_bound_by"],
        "s2_lse_library_ms": k3["stage2"]["sdpa_fwd_ms"],
        # phase 23: python -m dove_tpu_torch.train at 42 layers; K1 bounded
        # per validation (layers x DiT passes), K1-lse per fit step
        "validate_launches": [v["k1"] for v in fit["validations"]],
        "validate_passes": [v["passes"] for v in fit["validations"]],
        "fit_lse_launches_per_step": [s["launches"]["k1_lse"] for s in fit["steps"]],
        "fit_s2_lse_launches_per_step": [s["launches"]["k1_lse"]
                                         for s in fit["s2_steps"]],
        # phases 24-26: the CLI on mp4 files (2 layers, 2 clips), the drift
        # report's runs at 42 layers, one SFT step per optimizer (K1-lse)
        "video_cli_launches": video["runs"]["mp4"]["k1"],
        "drift_launches": drift_launches(drift, "k1"),
        "opt_lse_launches_per_step": {n: r["launches"]["k1_lse"]
                                      for n, r in opt["optimizers"].items()},
        # phase 30: world size 1 over NCCL (the clip through make_mesh(1, 1)),
        # and per rank of the TP=2 DiT (None where gloo took no CUDA tensors)
        "mesh_ws1_launches": parallel["clip_launches"],
        "tp2_launches_per_rank": _tp_rows(parallel, "bf16", "launches"),
        "tp2_shape": _tp_rows(parallel, "bf16", "shape"),
        "tp2_lse_launches_per_rank": _tp_step(parallel, "k1_lse"),
        # phase 34: the SFT step under tensor_parallel=2 and fsdp=2, per rank
        "c7_lse_launches_per_rank": _c7_launches(c7, "k1_lse"),
    }, {
        "name": "flash_fwd_qk8",
        "route": "cuda",
        "source": "dove_tpu_torch/csrc/flash_fwd_sm90.cu",
        "replaces": "dove_tpu/ops/pallas/flash_attention.py:107",
        "launches": int8_main["launches"],
        "launches_streamed": streamed["launches"],
        "fused_2l_launches": fused_2l["int8-dit"]["k2"],
        "fused_2l_calls": fused_2l["int8-dit"]["calls"],
        "fused_2l_tokens": fused_2l["int8-dit"]["tokens"],
        "fused_int8_launches": fused_2l["int8"]["k2"],
        "fused_max_abs_err": fused["held_worst"]["k2"],
        "max_abs_err": k2["max_abs_err"],
        "ms": k2["kernel_ms"],
        "plain_ms": k2["plain_ms"],
        "bound_ms": k2["bound_ms"],
        "bound_by": k2["bound_by"],
        "library_ms": k2["sdpa_ms"],
        "library_call": "scaled_dot_product_attention on the bf16 q, k, v: "
                        "a yardstick of a different function (bf16 Q K^T)",
        "timing": f"ms and k1_same_call_ms: medians of {K2_WINDOWS} interleaved "
                  "10-launch windows each",
        "k1_same_call_ms": k2["k1_same_call_ms"],
        "quantize_ms": k2["quantize_ms"],
        "wrapper_ms": k2["wrapper_ms"],
        "exp_floor_ms": k2["exp_floor_ms"],
        "sm_clock_mhz": k2["sm_clock_mhz"],
        "shape": k2["shape"],
        "drift_launches": drift_launches(drift, "k2"),
        "tp2_launches_per_rank": _tp_rows(parallel, "int8-dit", "launches"),
        "tp2_shape": _tp_rows(parallel, "int8-dit", "shape"),
    }]
    sdpa_bwd = ("scaled_dot_product_attention forward plus backward minus its "
                "forward: dq, dk and dv in one call")
    for name, key, line in (("flash_bwd_dq", "k3a", 253), ("flash_bwd_dkv", "k3b", 290)):
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": "dove_tpu_torch/csrc/flash_bwd_sm90.cu",
            "replaces": f"dove_tpu/ops/pallas/flash_attention.py:{line}",
            "launches": train["launches"][key],
            "launches_per_step": train["launches"][key] // TRAIN_STEPS,
            "max_abs_err": k3["worst"][key],
            "ms": k3[f"{key}_ms"],
            "plain_ms": k3[f"{key}_plain_ms"],
            "bound_ms": k3[f"{key}_bound_ms"],
            "bound_by": k3[f"{key}_bound_by"],
            "library_ms": k3["sdpa_bwd_ms"],
            "library_call": sdpa_bwd,
            "shape": k3["shape"],
            "s2_shape": k3["stage2"]["shape"],
            "s2_launches": s2["launches"][key],
            "s2_launches_per_step": s2["launches"][key] // S2_STEPS,
            "s2_ms": k3["stage2"][f"{key}_ms"],
            "s2_plain_ms": k3["stage2"][f"{key}_plain_ms"],
            "s2_bound_ms": k3["stage2"][f"{key}_bound_ms"],
            "s2_bound_by": k3["stage2"][f"{key}_bound_by"],
            "s2_library_ms": k3["stage2"]["sdpa_bwd_ms"],
            "fit_launches_per_step": [s["launches"][key] for s in fit["steps"]],
            "opt_launches_per_step": {n: r["launches"][key]
                                      for n, r in opt["optimizers"].items()},
            "mesh_ws1_launches": parallel["step"]["launches"][key],
            "tp2_launches_per_rank": _tp_step(parallel, key),
            "c7_launches_per_rank": _c7_launches(c7, key),
        })
    conv_source = "dove_tpu_torch/csrc/conv3d_taps_sm90.cu"
    kernels.append({
        "name": "conv3d_w8a8",
        "route": "cuda",
        "source": conv_source,
        "replaces": "dove_tpu/ops/pallas/conv3d_int8.py:244",
        "launches": dit_dec["launches"]["k4"],
        "launches_kt1": dit_dec["launches"]["k4_kt1"],
        "fused_int8_launches": fused_2l["int8"]["k4"],
        "fused_int8_launches_kt1": fused_2l["int8"]["k4_kt1"],
        "max_abs_err": k4["max_abs_err"],
        "ms": k4["ms"],
        "plain_ms": k4["plain_ms"],
        "bound_ms": k4["bound_ms"],
        "bound_by": k4["bound_by"],
        "library_ms": k4["library_bf16_conv3d_ms"],
        "library_call": "F.conv3d on bf16 operands of the same shape: a yardstick "
                        "of a different function (no int8 convolution is bound)",
        "shape": k4["shape"],
        "by_shape": k4["by_shape"],
        "drift_launches": drift_launches(drift, "k4"),
        "drift_launches_kt1": drift_launches(drift, "k4_kt1"),
    })
    kernels.append({
        "name": "conv3d_bf16",
        "route": "cuda",
        "source": conv_source,
        "replaces": "dove_tpu/ops/pallas/conv3d_int8.py:337",
        "launches": hand["launches"],
        "max_abs_err": k5["max_abs_err"],
        "ms": k5["ms"],
        "plain_ms": k5["plain_ms"],
        "bound_ms": k5["bound_ms"],
        "bound_by": k5["bound_by"],
        "library_ms": k5["library_ms"],
        "library_channels_last_ms": k5["library_channels_last_ms"],
        "library_call": "F.conv3d of the same bf16 tensors, NCDHW (and "
                        "channels_last_3d)",
        "shape": k5["shape"],
        "by_shape": k5["by_shape"],
    })
    kernels.append({
        "name": "quant_pack",
        "route": "cuda",
        "source": "dove_tpu_torch/csrc/conv3d_taps.cu",
        "replaces": "dove_tpu/ops/quant.py:240 (the quantizer's fused elementwise "
                    "chain, one XLA pass on the TPU; not a Pallas kernel)",
        "launches": dit_dec["launches"]["quantize"],
        "max_abs_err": quantizer["max_abs_err"],
        "ms": quantizer["ms"],
        "plain_ms": quantizer["plain_ms"],
        "bound_ms": quantizer["bound_ms"],
        "bound_by": quantizer["bound_by"],
        "library_ms": None,
        "shape": quantizer["shape"],
        "drift_launches": drift_launches(drift, "quantize"),
    })
    kernels.append({
        "name": "group_norm",
        "route": "cuda",
        "source": "dove_tpu_torch/csrc/group_norm_sm90.cu",
        "replaces": "none: the port's own (the JAX package's GroupNorm is XLA)",
        "max_rel_err": norm["decoder"]["worst_rel_err"],
        "ms": norm["decoder"]["ms"],
        "plain_ms": norm["decoder"]["plain_ms"],
        "bound_ms": norm["decoder"]["bound_ms"],
        "bound_by": "bytes",
        "library_ms": norm["decoder"]["library_ms"],
        "library_call": "F.group_norm, the affine, the nearest resize of the "
                        "modulation and F.silu: the route the port no longer takes",
        "shape": norm["decoder"]["shape"],
        "encoder": norm["encoder"],
    })
    kernels += fp16_kernel_rows(fp16, serving_2b, training_2b)
    kernels.append({
        "name": "flash_fwd_d128_bf16",
        "route": "cuda",
        "source": "dove_tpu_torch/csrc/flash_fwd_sm90.cu",
        "replaces": "dove_tpu/ops/pallas/flash_attention.py:75 at head dim 128",
        "max_abs_err": max(e["max_abs"] for r in (d128["self"], d128["cross"])
                           for e in r["errors"].values()),
        "ms": d128["self"]["ms"],
        "plain_ms": d128["self"]["plain_ms"],
        "bound_ms": d128["self"]["bound_ms"],
        "bound_by": d128["self"]["bound_by"],
        "library_ms": d128["self"]["sdpa_ms"],
        "shape": d128["self"]["shape"],
        "cross": d128["cross"],
    })
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
