"""E*warp, the optical-flow warping error of a clip, in PyTorch.

Counterpart of ``dove_tpu/eval/ewarp.py``: RAFT flow (``models/raft.py``)
between consecutive frames, the next frame warped back by the forward flow,
and a forward-backward consistency mask,

    E*warp = sum_t sum_px mask * ||I_t - warp(I_{t+1}, F_{t->t+1})||^2
             / (3 sum mask), reported x1e-3 like the published tables.

The frames are edge-padded to multiples of 8 for RAFT and cropped back. The
pairs go through RAFT ``pair_chunk`` at a time (a 720p pair's correlation
volume alone is 14,400^2 fp32, 0.83 GB); the pairs are independent, so the
chunks give the numbers one batch gives. fp32 without TF32, on the card
unless the caller passes ``device``; RAFT's weights from
``DOVE_RAFT_WEIGHTS``.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from dove_tpu_torch.models.raft import Weights, raft_flow, warp

PAIR_CHUNK = 4


def occlusion_mask(flow_fwd: torch.Tensor, flow_bwd: torch.Tensor, alpha1: float = 0.01,
                   alpha2: float = 0.5) -> torch.Tensor:
    """Valid where |F_fwd + warp(F_bwd)|^2 is small beside the flows'
    magnitudes: [B, H, W, 1] float mask."""
    bwd_warped = warp(flow_bwd, flow_fwd)
    diff = ((flow_fwd + bwd_warped) ** 2).sum(-1, keepdim=True)
    mag = (flow_fwd ** 2 + bwd_warped ** 2).sum(-1, keepdim=True)
    return (diff < alpha1 * mag + alpha2).float()


def ewarp_clip(weights: Weights, frames: np.ndarray, iters: int = 12,
               use_occlusion: bool = True, pair_chunk: int = PAIR_CHUNK) -> float:
    """Warping error of one clip [F, H, W, 3] in [0, 1] (x1e-3), on the
    weights' device."""
    from dove_tpu_torch.eval.vgg import full_fp32

    device = next(iter(weights.values())).device
    x = torch.as_tensor(np.asarray(frames, np.float32), device=device)
    F_, H, W, _ = x.shape
    pad_h, pad_w = (-H) % 8, (-W) % 8
    if pad_h or pad_w:
        x = F.pad(x.permute(0, 3, 1, 2), (0, pad_w, 0, pad_h),
                  mode="replicate").permute(0, 2, 3, 1)
    # each chunk's sums in fp32, their total in float64
    err = torch.zeros((), dtype=torch.float64, device=device)
    mask_sum = torch.zeros((), dtype=torch.float64, device=device)
    step = max(pair_chunk, 1)
    with torch.no_grad(), full_fp32():
        for s in range(0, F_ - 1, step):
            prev, nxt = x[s:s + step], x[s + 1:s + 1 + step]
            prev = prev[: len(nxt)]
            flow_fwd = raft_flow(weights, prev, nxt, iters)
            if use_occlusion:
                mask = occlusion_mask(flow_fwd, raft_flow(weights, nxt, prev, iters))
            else:
                mask = torch.ones(prev.shape[:3] + (1,), device=device)
            warped = warp(nxt, flow_fwd)[:, :H, :W]
            mask = mask[:, :H, :W]
            err = err + (((prev[:, :H, :W] - warped) ** 2) * mask).sum().double()
            mask_sum = mask_sum + mask.sum().double()
    return float(err / (mask_sum * 3.0 + 1e-8)) * 1000.0
