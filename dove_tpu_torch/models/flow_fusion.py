"""Optical-flow propagation and fusion in PyTorch.

Counterpart of ``dove_tpu/models/flow_fusion.py``: flow warping, the
forward-backward consistency mask, the bidirectional propagation (non-
learnable and BasicVSR++-style learnable, with modulated deformable
alignment), the zero-init residual fusion module, and bidirectional RAFT
flows of a clip. The released DOVE recipe calls none of them (its
``--use_optical_flow`` only loads RAFT); they are a library with the JAX
package's math:

  * channels-last tensors, [B, T, H, W, C], flows [B, T-1, H, W, 2] as
    (x, y) pixels;
  * ``flow_warp`` zeroes each bilinear corner outside the frame on its own;
    the nearest mode rounds half to even (``jnp.round``);
  * flows and clips are resized as ``jax.image.resize(..., "linear")`` does
    (:func:`resize_linear`): half-pixel centres, a triangle kernel widened on
    a downscale (antialiased), weights built on the host in float32 as JAX
    builds them. This is neither ``F.interpolate`` nor ``ops/resize.py``
    (cv2's arithmetic);
  * the deformable convolution is a plain bilinear gather per (group, tap),
    offsets (dy, dx) with the taps row-major, contracted with the weights
    (no torchvision);
  * convolutions pad as XLA's "SAME" (not causally, as the VAE's do); the
    recursion over frames is a loop over T;
  * the learnable propagation applies ``output_layer`` as constructed (the
    JAX package's fix of the reference's attribute-name slip).

Parameters are nested dicts of tensors in the JAX package's structure and
key names, each conv ``kernel`` in torch's layout ([O, I, kh, kw] or [O, I,
kt, kh, kw]) and the deformable conv's ``weight`` [O, I, 3, 3];
:func:`from_jax_propagation` and :func:`from_jax_fusion_module` carry the
JAX package's trees across, the ``init_*`` functions draw seeded ones.
"""

from __future__ import annotations

import math
from typing import Any

import numpy as np
import torch
import torch.nn.functional as F

Params = dict[str, Any]


# ---------------------------------------------------------------------------
# Resize as jax.image.resize(..., "linear")
# ---------------------------------------------------------------------------

def linear_weights(n_in: int, n_out: int) -> np.ndarray:
    """[n_in, n_out] float32 weights of ``jax.image.resize``'s "linear"
    method (``compute_weight_mat``, antialias on, no translation)."""
    inv_scale = np.float32(1.0 / (n_out / n_in))
    kernel_scale = max(inv_scale, np.float32(1.0))
    sample_f = ((np.arange(n_out, dtype=np.float32) + np.float32(0.5)) * inv_scale
                - np.float32(0.5))
    x = np.abs(sample_f[None, :] - np.arange(n_in, dtype=np.float32)[:, None]) / kernel_scale
    w = np.maximum(np.float32(0.0), np.float32(1.0) - np.abs(x))
    total = w.sum(axis=0, keepdims=True)
    w = np.where(np.abs(total) > 1000.0 * float(np.finfo(np.float32).eps),
                 w / np.where(total != 0, total, np.float32(1.0)), np.float32(0.0))
    inside = (sample_f >= -0.5) & (sample_f <= n_in - 0.5)
    return np.where(inside[None, :], w, np.float32(0.0)).astype(np.float32)


def resize_linear(x: torch.Tensor, hw: tuple[int, int]) -> torch.Tensor:
    """Resize dims -3 and -2 of ``x`` ([..., H, W, C]) to ``hw`` as
    ``jax.image.resize(..., "linear")`` does; a dim of equal size is left
    alone."""
    H, W = x.shape[-3], x.shape[-2]
    if H != hw[0]:
        wh = torch.from_numpy(linear_weights(H, hw[0])).to(x.device, x.dtype)
        x = torch.einsum("...hwc,hH->...Hwc", x, wh)
    if W != hw[1]:
        ww = torch.from_numpy(linear_weights(W, hw[1])).to(x.device, x.dtype)
        x = torch.einsum("...hwc,wW->...hWc", x, ww)
    return x


# ---------------------------------------------------------------------------
# Flow warping (grid_sample align_corners=True, zeros padding semantics)
# ---------------------------------------------------------------------------

def _gather_frames(x: torch.Tensor, ix: torch.Tensor, iy: torch.Tensor) -> torch.Tensor:
    """x[b, iy, ix] for x [B, H, W, C] and integer maps [B, H', W'], zero
    outside the frame."""
    B, H, W, C = x.shape
    valid = (ix >= 0) & (ix <= W - 1) & (iy >= 0) & (iy <= H - 1)
    idx = iy.clamp(0, H - 1).long() * W + ix.clamp(0, W - 1).long()
    idx = idx + torch.arange(B, device=x.device).view(B, 1, 1) * (H * W)
    out = x.reshape(B * H * W, C).index_select(0, idx.reshape(-1))
    return out.reshape(*ix.shape, C) * valid[..., None].to(x.dtype)


def _grid(H: int, W: int, like: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    gy, gx = torch.meshgrid(torch.arange(H, device=like.device),
                            torch.arange(W, device=like.device), indexing="ij")
    return gy.to(like.dtype), gx.to(like.dtype)


def flow_warp(x: torch.Tensor, flow: torch.Tensor,
              interp_mode: str = "bilinear") -> torch.Tensor:
    """Warp [B, H, W, C] by flow [B, H, W, 2] ((x, y) displacements): x
    sampled at p + flow(p), zero outside the frame."""
    B, H, W, C = x.shape
    gy, gx = _grid(H, W, x)
    vx = gx[None] + flow[..., 0]
    vy = gy[None] + flow[..., 1]
    if interp_mode == "nearest":
        return _gather_frames(x, torch.round(vx).int(), torch.round(vy).int())
    if interp_mode != "bilinear":
        raise ValueError(f"interp_mode {interp_mode!r}: bilinear|nearest")
    x0, y0 = torch.floor(vx), torch.floor(vy)
    wx = (vx - x0)[..., None].to(x.dtype)
    wy = (vy - y0)[..., None].to(x.dtype)
    x0i, y0i = x0.int(), y0.int()
    v00 = _gather_frames(x, x0i, y0i)
    v01 = _gather_frames(x, x0i + 1, y0i)
    v10 = _gather_frames(x, x0i, y0i + 1)
    v11 = _gather_frames(x, x0i + 1, y0i + 1)
    return ((1 - wy) * ((1 - wx) * v00 + wx * v01)
            + wy * ((1 - wx) * v10 + wx * v11))


def fb_consistency(flow_fw: torch.Tensor, flow_bw: torch.Tensor,
                   alpha1: float = 0.01, alpha2: float = 0.5) -> torch.Tensor:
    """Forward-backward consistency mask [B, H, W, 1] in {0, 1}: a pixel is
    flow-valid when |f_fw + f_bw(p + f_fw)|^2 is small relative to the flow
    magnitudes."""
    def length_sq(f):
        return (f * f).sum(dim=-1, keepdim=True)

    bw_warped = flow_warp(flow_bw, flow_fw)
    diff = flow_fw + bw_warped
    thresh = alpha1 * (length_sq(flow_fw) + length_sq(bw_warped)) + alpha2
    return (length_sq(diff) < thresh).to(flow_fw.dtype)


def resize_flows(flows: torch.Tensor, hw: tuple[int, int]) -> torch.Tensor:
    """[B, T-1, h, w, 2] -> [B, T-1, H, W, 2], values scaled by W/w."""
    h, w = flows.shape[2], flows.shape[3]
    if (h, w) == tuple(hw):
        return flows
    scale = torch.tensor(hw[1] / w, dtype=flows.dtype, device=flows.device)
    return resize_linear(flows, hw) * scale


# ---------------------------------------------------------------------------
# Non-learnable propagation (optical_flow_process / optical_flow_feature)
# ---------------------------------------------------------------------------

def _directional_prop(feats, flows_prop, flows_check, reverse: bool, mode: str,
                      fuse_scale: float, alpha1: float, alpha2: float,
                      interp: str) -> torch.Tensor:
    """One propagation direction, frame by frame. feats [B, T, H, W, C];
    flows_* [B, T-1, H, W, 2]. ``reverse`` runs t-1 .. 0 (the backward
    branch, propagating with the forward flows): frame idx then takes flow
    idx, the forward branch takes flow idx - 1; the first frame passes."""
    if mode not in ("fuse", "copy"):
        raise ValueError(f"mode {mode!r}: fuse|copy")
    T = feats.shape[1]
    outs: list[torch.Tensor] = [None] * T  # type: ignore[list-item]
    feat_prop = None
    for i, idx in enumerate(range(T - 1, -1, -1) if reverse else range(T)):
        feat_current = feats[:, idx]
        if i == 0:
            feat_prop = feat_current
        else:
            fi = idx if reverse else idx - 1
            flow_prop, flow_check = flows_prop[:, fi], flows_check[:, fi]
            mask = fb_consistency(flow_prop, flow_check, alpha1, alpha2)
            warped = flow_warp(feat_prop, flow_prop, interp)
            if mode == "fuse":
                warped = warped * fuse_scale + feat_current * (1.0 - fuse_scale)
            feat_prop = mask * warped + (1.0 - mask) * feat_current
        outs[idx] = feat_prop
    return torch.stack(outs, dim=1)


def optical_flow_process(x, flows_forward, flows_backward, *, interpolation="bilinear",
                         mode="fuse", fuse_scale=0.5, alpha1=0.01, alpha2=0.5):
    """Chained backward-then-forward propagation; returns the forward pass.
    x [B, T, H, W, C]."""
    H, W = x.shape[2], x.shape[3]
    ff = resize_flows(flows_forward, (H, W))
    fb = resize_flows(flows_backward, (H, W))
    back = _directional_prop(x, ff, fb, True, mode, fuse_scale, alpha1, alpha2,
                             interpolation)
    return _directional_prop(back, fb, ff, False, mode, fuse_scale, alpha1, alpha2,
                             interpolation)


def optical_flow_feature(x, flows_forward, flows_backward, *, interpolation="bilinear",
                         mode="copy", fuse_scale=0.5, alpha1=0.01, alpha2=0.5):
    """Independent backward and forward propagations of the same input ->
    (backward_feats, forward_feats), the fusion module's inputs."""
    H, W = x.shape[2], x.shape[3]
    ff = resize_flows(flows_forward, (H, W))
    fb = resize_flows(flows_backward, (H, W))
    back = _directional_prop(x, ff, fb, True, mode, fuse_scale, alpha1, alpha2,
                             interpolation)
    fwd = _directional_prop(x, fb, ff, False, mode, fuse_scale, alpha1, alpha2,
                            interpolation)
    return back, fwd


# ---------------------------------------------------------------------------
# Modulated deformable convolution (gather formulation)
# ---------------------------------------------------------------------------

_TAPS = [(dy, dx) for dy in (-1, 0, 1) for dx in (-1, 0, 1)]


def modulated_deform_conv(x: torch.Tensor, offset: torch.Tensor, mask: torch.Tensor,
                          weight: torch.Tensor,
                          bias: torch.Tensor | None = None) -> torch.Tensor:
    """DCNv2 with a 3x3 kernel, stride 1, pad 1 (torchvision
    ``deform_conv2d``'s semantics, the reference's only configuration).

    x      [B, H, W, C_in]
    offset [B, H, W, G, K, 2]  (dy, dx) per deform group g and tap k (taps
                               row-major over the 3x3 window)
    mask   [B, H, W, G, K]     modulation in [0, 1]
    weight [C_out, C_in, 3, 3]
    """
    B, H, W, Cin = x.shape
    G, K = offset.shape[3], offset.shape[4]
    if K != 9:
        raise ValueError("only 3x3 kernels supported (K=9)")
    if Cin % G:
        raise ValueError(f"deform groups {G} must divide C_in {Cin}")
    cg = Cin // G
    gy, gx = _grid(H, W, x)
    taps = torch.tensor(_TAPS, dtype=x.dtype, device=x.device)
    vy = gy[None, :, :, None, None] + taps[:, 0] + offset[..., 0]  # [B, H, W, G, K]
    vx = gx[None, :, :, None, None] + taps[:, 1] + offset[..., 1]
    vyf = vy.permute(0, 3, 1, 2, 4).reshape(B, G, H * W * K)
    vxf = vx.permute(0, 3, 1, 2, 4).reshape(B, G, H * W * K)
    x0, y0 = torch.floor(vxf), torch.floor(vyf)
    wx = (vxf - x0)[..., None].to(x.dtype)
    wy = (vyf - y0)[..., None].to(x.dtype)
    # each (batch, group) slab of H*W rows of cg channels, flattened
    slab = x.reshape(B, H * W, G, cg).permute(0, 2, 1, 3).reshape(B * G * H * W, cg)
    base = torch.arange(B * G, device=x.device).view(B, G, 1) * (H * W)

    def g4(ix, iy):
        valid = (ix >= 0) & (ix <= W - 1) & (iy >= 0) & (iy <= H - 1)
        idx = iy.clamp(0, H - 1).long() * W + ix.clamp(0, W - 1).long() + base
        out = slab.index_select(0, idx.reshape(-1)).reshape(B, G, H * W * K, cg)
        return out * valid[..., None].to(x.dtype)

    x0i, y0i = x0.long(), y0.long()
    sampled = ((1 - wy) * ((1 - wx) * g4(x0i, y0i) + wx * g4(x0i + 1, y0i))
               + wy * ((1 - wx) * g4(x0i, y0i + 1) + wx * g4(x0i + 1, y0i + 1)))
    # [B, G, H*W*K, cg] -> [B, H, W, K, G, cg]
    sampled = sampled.reshape(B, G, H, W, K, cg).permute(0, 2, 3, 4, 1, 5)
    sampled = sampled * mask.permute(0, 1, 2, 4, 3)[..., None]
    w_k = weight.permute(2, 3, 1, 0).reshape(K, Cin, -1)  # [K, Cin, Cout]
    out = torch.einsum("bhwkc,kco->bhwo", sampled.reshape(B, H, W, K, Cin), w_k)
    return out + bias if bias is not None else out


# ---------------------------------------------------------------------------
# Learnable modules (parameter trees + forwards)
# ---------------------------------------------------------------------------

def _same(k: int) -> tuple[int, int]:
    return (k - 1) // 2, k - 1 - (k - 1) // 2


def _conv2d(p: Params, x: torch.Tensor) -> torch.Tensor:
    """Stride-1 "SAME" conv of channels-last [B, H, W, C]."""
    kh, kw = p["kernel"].shape[2:]
    xc = F.pad(x.permute(0, 3, 1, 2), (*_same(kw), *_same(kh)))
    return F.conv2d(xc, p["kernel"], p.get("bias")).permute(0, 2, 3, 1)


def _conv3d(p: Params, x: torch.Tensor) -> torch.Tensor:
    """Stride-1 "SAME" conv of channels-last [B, T, H, W, C]."""
    kt, kh, kw = p["kernel"].shape[2:]
    xc = F.pad(x.permute(0, 4, 1, 2, 3), (*_same(kw), *_same(kh), *_same(kt)))
    return F.conv3d(xc, p["kernel"], p.get("bias")).permute(0, 2, 3, 4, 1)


def _group_norm(p: Params, x: torch.Tensor, groups: int, eps: float = 1e-5) -> torch.Tensor:
    """GroupNorm over every axis but the batch's, channels-last."""
    C = x.shape[-1]
    g = x.reshape(*x.shape[:-1], groups, C // groups)
    axes = tuple(range(1, g.ndim - 2)) + (g.ndim - 1,)
    mean = g.mean(axes, keepdim=True)
    var = (g - mean).square().mean(axes, keepdim=True)
    g = (g - mean) * torch.rsqrt(var + eps)
    return g.reshape(x.shape) * p["scale"] + p["bias"]


def conv_residual_blocks(p: Params, x: torch.Tensor) -> torch.Tensor:
    """Conv -> LReLU -> N x (conv-relu-conv residual, BasicSR
    ResidualBlockNoBN). x [B, H, W, C_in]."""
    h = F.leaky_relu(_conv2d(p["conv_in"], x), 0.1)
    for blk in p["blocks"]:
        h = h + _conv2d(blk["conv2"], F.relu(_conv2d(blk["conv1"], h)))
    return h


def deformable_alignment(p: Params, x, cond, flow, max_residue_magnitude: float = 10.0,
                         groups: int = 16):
    """The reference's DeformableAlignment: a conv stack predicts per-tap
    offsets (tanh-bounded, centred on the flow: dy = flow_y, dx = flow_x)
    and modulation masks, then the modulated deformable conv aligns x. cond
    = concat(current, warped, flow, valid mask), channels-last."""
    h = cond
    for i in range(3):
        h = F.leaky_relu(_conv2d(p[f"offset_conv{i}"], h), 0.1)
    out = _conv2d(p["offset_out"], h)  # [B, H, W, 27 * G]
    B, H, W, _ = out.shape
    o1, o2, mask = torch.chunk(out, 3, dim=-1)
    off = max_residue_magnitude * torch.tanh(torch.cat([o1, o2], dim=-1))
    off = off.reshape(B, H, W, groups, 9, 2)
    offset = torch.stack([off[..., 0] + flow[..., 1, None, None],
                          off[..., 1] + flow[..., 0, None, None]], dim=-1)
    mask = torch.sigmoid(mask).reshape(B, H, W, groups, 9)
    return modulated_deform_conv(x, offset, mask, p["weight"], p.get("bias"))


def propagation_forward(p: Params | None, x, flows_forward, flows_backward, *,
                        interpolation="bilinear", mode="fuse", fuse_scale=0.5,
                        alpha1=0.01, alpha2=0.5, groups: int = 16,
                        max_residue_magnitude: float = 10.0):
    """The reference's Propagation.forward. x [B, T, H, W, C].

    p=None runs the non-learnable variant (the mask-gated warp blend). With
    parameters each direction aligns the propagated feature by deformable
    alignment conditioned on (current, warped, flow, mask) and refines it
    with a residual backbone; a fusion stack adds a residual to the original
    input, through ``output_layer`` where the parameters have one."""
    H, W = x.shape[2], x.shape[3]
    ff = resize_flows(flows_forward, (H, W))
    fb = resize_flows(flows_backward, (H, W))
    if p is None:
        back = _directional_prop(x, ff, fb, True, mode, fuse_scale, alpha1, alpha2,
                                 interpolation)
        return _directional_prop(back, fb, ff, False, mode, fuse_scale, alpha1, alpha2,
                                 interpolation)

    x_orig = x
    if "input_layer" in p:
        x = _conv3d(p["input_layer"], x)

    def learnable_dir(feats, flows_prop, flows_check, branch, reverse):
        T = feats.shape[1]
        outs = [None] * T
        feat_prop = None
        for i, idx in enumerate(range(T - 1, -1, -1) if reverse else range(T)):
            feat_current = feats[:, idx]
            if i == 0:
                feat_prop = feat_current
            else:
                fi = idx if reverse else idx - 1
                flow_prop, flow_check = flows_prop[:, fi], flows_check[:, fi]
                mask = fb_consistency(flow_prop, flow_check, alpha1, alpha2)
                warped = flow_warp(feat_prop, flow_prop, interpolation)
                cond = torch.cat([feat_current, warped, flow_prop, mask], dim=-1)
                feat_prop = deformable_alignment(p[branch]["deform"], feat_prop, cond,
                                                 flow_prop, max_residue_magnitude, groups)
            feat = torch.cat([feat_current, feat_prop], dim=-1)
            feat_prop = feat_prop + conv_residual_blocks(p[branch]["backbone"], feat)
            outs[idx] = feat_prop
        return torch.stack(outs, dim=1)

    back = learnable_dir(x, ff, fb, "backward_prop", True)
    fwd = learnable_dir(back, fb, ff, "forward_prop", False)
    B, T = x.shape[:2]
    cat = torch.cat([x, back, fwd], dim=-1)
    fused = conv_residual_blocks(p["fuse"], cat.reshape(B * T, *cat.shape[2:]))
    fused = fused.reshape(B, T, *fused.shape[1:])
    if "output_layer" in p:
        fused = _conv3d(p["output_layer"], fused)
    return fused + x_orig


def fusion_module_forward(p: Params, x, backward_feat, forward_feat, groups: int = 8):
    """The reference's OpticalFlowFusionModule: concat(x, back, fwd) ->
    1x1x1 conv + GN + SiLU -> N x 3-D residual blocks -> a zero-init 1x1x1
    residual added to x. All tensors [B, T, H, W, C]."""
    h = torch.cat([x, backward_feat, forward_feat], dim=-1)
    h = F.silu(_group_norm(p["initial_norm"], _conv3d(p["initial_conv"], h), groups))
    for blk in p["blocks"]:
        ident = h
        if "shortcut_conv" in blk:
            ident = _group_norm(blk["shortcut_norm"], _conv3d(blk["shortcut_conv"], h),
                                groups)
        o = _conv3d(blk["conv1"], F.silu(_group_norm(blk["norm1"], h, groups)))
        o = _conv3d(blk["conv2"], F.silu(_group_norm(blk["norm2"], o, groups)))
        h = o + ident
    return x + _conv3d(p["final_proj"], h)


# ---------------------------------------------------------------------------
# Bidirectional RAFT flows (the reference's RAFT_bi)
# ---------------------------------------------------------------------------

def raft_bi_clip(raft_weights, clip: torch.Tensor, iters: int = 20,
                 short_clip_len: int = 25):
    """Frozen-RAFT forward and backward flows of a clip.

    clip [B, T, H, W, 3] in [0, 1] -> (flows_forward, flows_backward), each
    [B, T-1, H, W, 2] in (x, y) pixels: H and W resized up to multiples of 8
    for RAFT and the flows resized back and rescaled; a clip longer than
    ``short_clip_len`` runs in windows of that many frames that share one
    boundary frame."""
    from dove_tpu_torch.models.raft import raft_flow

    B, T, H, W, _ = clip.shape
    if T > short_clip_len:
        ff, fb = [], []
        for f0 in range(0, T, short_clip_len):
            end = min(T, f0 + short_clip_len)
            start = f0 if f0 == 0 else f0 - 1
            a, b = raft_bi_clip(raft_weights, clip[:, start:end], iters,
                                short_clip_len=10**9)
            ff.append(a)
            fb.append(b)
        return torch.cat(ff, dim=1), torch.cat(fb, dim=1)

    H8, W8 = -(-H // 8) * 8, -(-W // 8) * 8
    frames = clip if (H8, W8) == (H, W) else resize_linear(clip, (H8, W8))
    a = frames[:, :-1].reshape(B * (T - 1), H8, W8, 3)
    b = frames[:, 1:].reshape(B * (T - 1), H8, W8, 3)
    fwd = raft_flow(raft_weights, a, b, iters=iters)
    bwd = raft_flow(raft_weights, b, a, iters=iters)

    def back_to(flow):
        flow = flow.reshape(B, T - 1, H8, W8, 2)
        if (H8, W8) == (H, W):
            return flow
        scale = torch.tensor([W / W8, H / H8], dtype=flow.dtype, device=flow.device)
        return resize_linear(flow, (H, W)) * scale

    return back_to(fwd), back_to(bwd)


# ---------------------------------------------------------------------------
# Parameters: the JAX package's trees, seeded initialisers
# ---------------------------------------------------------------------------

def _torch_kernel(k: np.ndarray) -> np.ndarray:
    """HWIO -> OIHW, DHWIO -> OIDHW."""
    k = np.asarray(k)
    return np.transpose(k, (k.ndim - 1, k.ndim - 2) + tuple(range(k.ndim - 2)))


def _from_jax(tree: Any, device, dtype) -> Any:
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            if k in ("kernel", "weight") and not isinstance(v, (dict, list)):
                v = _torch_kernel(v)
            out[k] = _from_jax(v, device, dtype)
        return out
    if isinstance(tree, (list, tuple)):
        return [_from_jax(v, device, dtype) for v in tree]
    return torch.tensor(np.array(tree), dtype=dtype, device=device)


def from_jax_propagation(params: Params, device="cpu", dtype=torch.float32) -> Params:
    """The JAX package's ``init_propagation_params`` tree (NumPy leaves) ->
    the port's (kernels in torch's layout)."""
    return _from_jax(params, device, dtype)


def from_jax_fusion_module(params: Params, device="cpu", dtype=torch.float32) -> Params:
    """The JAX package's ``init_fusion_module_params`` tree -> the port's."""
    return _from_jax(params, device, dtype)


class _Draw:
    """Seeded normal draws on a device."""

    def __init__(self, seed: int, device, dtype):
        self.gen = torch.Generator(device=device).manual_seed(seed)
        self.device, self.dtype = device, dtype

    def normal(self, shape, std: float) -> torch.Tensor:
        return (torch.randn(shape, generator=self.gen, device=self.device) * std).to(self.dtype)

    def zeros(self, shape) -> torch.Tensor:
        return torch.zeros(shape, device=self.device, dtype=self.dtype)

    def conv2d(self, kh, kw, cin, cout, scale=None) -> Params:
        std = scale if scale is not None else math.sqrt(2.0 / (kh * kw * cin))
        return {"kernel": self.normal((cout, cin, kh, kw), std), "bias": self.zeros((cout,))}

    def conv3d(self, kt, kh, kw, cin, cout, zero=False) -> Params:
        shape = (cout, cin, kt, kh, kw)
        kernel = (self.zeros(shape) if zero
                  else self.normal(shape, math.sqrt(2.0 / (kt * kh * kw * cin))))
        return {"kernel": kernel, "bias": self.zeros((cout,))}

    def gn(self, ch) -> Params:
        return {"scale": torch.ones(ch, device=self.device, dtype=self.dtype),
                "bias": self.zeros((ch,))}

    def crb(self, cin, cout, num_blocks) -> Params:
        # ResidualBlockNoBN scales its residual convs by 0.1
        res = 0.1 * math.sqrt(2.0 / (9 * cout))
        return {"conv_in": self.conv2d(3, 3, cin, cout),
                "blocks": [{"conv1": self.conv2d(3, 3, cout, cout, res),
                            "conv2": self.conv2d(3, 3, cout, cout, res)}
                           for _ in range(num_blocks)]}


def init_propagation_params(in_channels: int, mid_channels: int = 256, num_blocks: int = 2,
                            groups: int = 16, seed: int = 0, device="cpu",
                            dtype=torch.float32) -> Params:
    """The JAX package's ``init_propagation_params`` at its scales, drawn
    from a generator seeded with ``seed``: the offset head zero (at init the
    deformable conv samples at the flow-displaced taps with mask 0.5)."""
    d = _Draw(seed, device, dtype)
    p: Params = {}
    if mid_channels != in_channels:
        p["input_layer"] = d.conv3d(3, 1, 1, in_channels, mid_channels)
        p["output_layer"] = d.conv3d(3, 1, 1, mid_channels, in_channels)
    cond_ch = 2 * mid_channels + 2 + 1
    for branch in ("backward_prop", "forward_prop"):
        p[branch] = {
            "deform": {
                "offset_conv0": d.conv2d(3, 3, cond_ch, mid_channels),
                "offset_conv1": d.conv2d(3, 3, mid_channels, mid_channels),
                "offset_conv2": d.conv2d(3, 3, mid_channels, mid_channels),
                "offset_out": {"kernel": d.zeros((27 * groups, mid_channels, 3, 3)),
                               "bias": d.zeros((27 * groups,))},
                "weight": d.normal((mid_channels, mid_channels, 3, 3),
                                   math.sqrt(2.0 / (9 * mid_channels))),
                "bias": d.zeros((mid_channels,)),
            },
            "backbone": d.crb(2 * mid_channels, mid_channels, num_blocks),
        }
    p["fuse"] = d.crb(3 * mid_channels, mid_channels, 2)
    return p


def init_fusion_module_params(latent_channels: int, mid_channels: int | None = None,
                              num_res_blocks: int = 2, seed: int = 0, device="cpu",
                              dtype=torch.float32) -> Params:
    """The JAX package's ``init_fusion_module_params``: the final projection
    zero, so the module is the identity at init."""
    d = _Draw(seed, device, dtype)
    mid = mid_channels or latent_channels * 2
    return {
        "initial_conv": d.conv3d(1, 1, 1, latent_channels * 3, mid),
        "initial_norm": d.gn(mid),
        "blocks": [{"norm1": d.gn(mid), "conv1": d.conv3d(3, 3, 3, mid, mid),
                    "norm2": d.gn(mid), "conv2": d.conv3d(3, 3, 3, mid, mid)}
                   for _ in range(num_res_blocks)],
        "final_proj": d.conv3d(1, 1, 1, mid, latent_channels, zero=True),
    }
