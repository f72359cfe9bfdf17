"""RAFT optical flow in PyTorch: the backbone of the E*warp metric.

Counterpart of ``dove_tpu/models/raft.py`` (princeton-vl RAFT: BasicEncoder
feature and context nets at 1/8 resolution, the all-pairs correlation
pyramid, the SepConvGRU update block, convex 8x upsampling), with its
numerics: convolutions pad as XLA's "SAME" does (for a stride-2 conv on an
even size one more row and column at the bottom and right than at the top
and left), correlation lookups are bilinear samples with zeros outside, the
window's first axis offsets x (princeton-vl's channel order), and only the
last iteration's upsampling mask is kept.

The weights are a dict of tensors under raft-things.pth's names
(``fnet.*``, ``cnet.*``, ``update_block.*``): :func:`convert_raft` reads the
published checkpoint, :func:`from_jax_raft` the JAX package's tree. The
context net's norms are frozen BatchNorms where the weights carry running
statistics, the feature net's instance norms (affine where weighted).
Activations are NCHW inside; images enter and flows leave as [B, H, W, C].
"""

from __future__ import annotations

from pathlib import Path
from typing import Any, Mapping

import numpy as np
import torch
import torch.nn.functional as F

CORR_LEVELS = 4
CORR_RADIUS = 4

Weights = dict[str, torch.Tensor]


# ---------------------------------------------------------------------------
# Primitives
# ---------------------------------------------------------------------------

def _same_pad(n: int, k: int, stride: int) -> tuple[int, int]:
    total = max((-(-n // stride) - 1) * stride + k - n, 0)
    return total // 2, total - total // 2


def conv(w: Weights, name: str, x: torch.Tensor, stride: int = 1) -> torch.Tensor:
    """NCHW conv with ``name.weight`` (OIHW) and ``name.bias`` if present,
    padded as XLA's "SAME"."""
    weight = w[f"{name}.weight"]
    kh, kw = weight.shape[2:]
    (t, b), (l, r) = (_same_pad(x.shape[2], kh, stride),
                      _same_pad(x.shape[3], kw, stride))
    return F.conv2d(F.pad(x, (l, r, t, b)), weight, w.get(f"{name}.bias"), stride)


def norm(w: Weights, name: str, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """Frozen BatchNorm when ``name`` has running statistics, else instance
    norm (affine when ``name`` is weighted)."""
    if f"{name}.running_mean" in w:
        shape = (1, -1, 1, 1)
        y = (x - w[f"{name}.running_mean"].view(shape)) * torch.rsqrt(
            w[f"{name}.running_var"].view(shape) + eps)
        return y * w[f"{name}.weight"].view(shape) + w[f"{name}.bias"].view(shape)
    return F.instance_norm(x, weight=w.get(f"{name}.weight"),
                           bias=w.get(f"{name}.bias"), eps=eps)


def bilinear_sample(img: torch.Tensor, coords: torch.Tensor) -> torch.Tensor:
    """img [B, H, W, C]; coords [B, h, w, 2] absolute (x, y) -> [B, h, w, C],
    zero outside, combined as the JAX package combines the four corners."""
    B, H, W, C = img.shape
    x, y = coords[..., 0], coords[..., 1]
    x0, y0 = torch.floor(x), torch.floor(y)
    wx, wy = (x - x0)[..., None], (y - y0)[..., None]
    flat = img.reshape(B, H * W, C)

    def gather(yi, xi):
        valid = (xi >= 0) & (xi <= W - 1) & (yi >= 0) & (yi <= H - 1)
        idx = (yi.clamp(0, H - 1).long() * W + xi.clamp(0, W - 1).long()).reshape(B, -1)
        vals = torch.gather(flat, 1, idx[..., None].expand(-1, -1, C))
        return vals.reshape(*coords.shape[:-1], C) * valid[..., None].to(img.dtype)

    top = gather(y0, x0) * (1 - wx) + gather(y0, x0 + 1) * wx
    bot = gather(y0 + 1, x0) * (1 - wx) + gather(y0 + 1, x0 + 1) * wx
    return top * (1 - wy) + bot * wy


def _grid(B: int, H: int, W: int, device) -> torch.Tensor:
    ys, xs = torch.meshgrid(torch.arange(H, device=device), torch.arange(W, device=device),
                            indexing="ij")
    return torch.stack([xs, ys], dim=-1).float()[None].expand(B, H, W, 2)


def warp(img: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
    """Backward warp: out(x) = img(x + flow(x)); img [B, H, W, C], flow
    [B, H, W, 2] in pixels."""
    B, H, W, _ = img.shape
    return bilinear_sample(img, _grid(B, H, W, img.device) + flow)


# ---------------------------------------------------------------------------
# Encoders, correlation, update block
# ---------------------------------------------------------------------------

def encoder(w: Weights, net: str, x: torch.Tensor) -> torch.Tensor:
    """x: [B, 3, H, W] in [-1, 1] -> [B, C, H/8, W/8]."""
    h = F.relu(norm(w, f"{net}.norm1", conv(w, f"{net}.conv1", x, 2)))
    for i, stride in ((1, 1), (2, 2), (3, 2)):
        for j in range(2):
            pre, s = f"{net}.layer{i}.{j}", stride if j == 0 else 1
            y = F.relu(norm(w, f"{pre}.norm1", conv(w, f"{pre}.conv1", h, s)))
            y = F.relu(norm(w, f"{pre}.norm2", conv(w, f"{pre}.conv2", y)))
            if f"{pre}.downsample.0.weight" in w:
                h = norm(w, f"{pre}.norm3", conv(w, f"{pre}.downsample.0", h, s))
            h = F.relu(h + y)
    return conv(w, f"{net}.conv2", h)


def corr_pyramid(f1: torch.Tensor, f2: torch.Tensor) -> list[tuple[torch.Tensor, float]]:
    """All-pairs correlation of [B, D, h, w] features, then 2x average pools
    over the target axes: levels of ([B*h*w, h_l, w_l, 1], scale); a level
    too small to pool repeats the one before at its scale."""
    B, D, h, w = f1.shape
    corr = torch.matmul(f1.flatten(2).transpose(1, 2), f2.flatten(2))  # [B, hw, hw]
    corr = (corr / torch.sqrt(torch.tensor(float(D)))).reshape(B * h * w, 1, h, w)
    levels, scale = [(corr, 1.0)], 1.0
    for _ in range(CORR_LEVELS - 1):
        if corr.shape[2] >= 2 and corr.shape[3] >= 2:
            corr = F.avg_pool2d(corr, 2)
            scale *= 2.0
        levels.append((corr, scale))
    return [(c.permute(0, 2, 3, 1), s) for c, s in levels]


def _deltas(device) -> torch.Tensor:
    r = torch.arange(-CORR_RADIUS, CORR_RADIUS + 1, dtype=torch.float32, device=device)
    di, dj = torch.meshgrid(r, r, indexing="ij")
    return torch.stack([di, dj], dim=-1)  # [i, j] = (x offset d_i, y offset d_j)


def corr_lookup(pyramid, coords: torch.Tensor) -> torch.Tensor:
    """(2r+1)^2 neighbourhoods at each level around coords / scale; coords
    [B, h, w, 2] -> [B, levels * (2r+1)^2, h, w]."""
    B, h, w, _ = coords.shape
    flat = coords.reshape(B * h * w, 1, 1, 2)
    deltas = _deltas(coords.device)[None]
    out = [bilinear_sample(corr, flat / scale + deltas).reshape(B, h, w, -1)
           for corr, scale in pyramid]
    return torch.cat(out, dim=-1).permute(0, 3, 1, 2)


def _update(w: Weights, net: torch.Tensor, inp: torch.Tensor, corr: torch.Tensor,
            flow: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One update: (hidden state, flow delta, upsampling mask), NCHW."""
    e, relu = "update_block.encoder", F.relu
    c = relu(conv(w, f"{e}.convc2", relu(conv(w, f"{e}.convc1", corr))))
    f = relu(conv(w, f"{e}.convf2", relu(conv(w, f"{e}.convf1", flow))))
    motion = torch.cat([relu(conv(w, f"{e}.conv", torch.cat([c, f], 1))), flow], 1)
    x = torch.cat([inp, motion], 1)
    h = net
    for axis in ("1", "2"):  # 1x5, then 5x1
        hx = torch.cat([h, x], 1)
        z = torch.sigmoid(conv(w, f"update_block.gru.convz{axis}", hx))
        r = torch.sigmoid(conv(w, f"update_block.gru.convr{axis}", hx))
        q = torch.tanh(conv(w, f"update_block.gru.convq{axis}", torch.cat([r * h, x], 1)))
        h = (1 - z) * h + z * q
    delta = conv(w, "update_block.flow_head.conv2",
                 relu(conv(w, "update_block.flow_head.conv1", h)))
    mask = conv(w, "update_block.mask.2", relu(conv(w, "update_block.mask.0", h))) * 0.25
    return h, delta, mask


def upsample_flow(flow: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Convex 8x upsampling: flow [B, h, w, 2], mask [B, h, w, 9*64] ->
    [B, 8h, 8w, 2]."""
    B, h, w, _ = flow.shape
    mask = torch.softmax(mask.reshape(B, h, w, 9, 8, 8), dim=3)
    fp = F.pad(flow * 8.0, (0, 0, 1, 1, 1, 1))
    neigh = torch.stack([fp[:, dy:dy + h, dx:dx + w] for dy in range(3) for dx in range(3)],
                        dim=3)  # [B, h, w, 9, 2]
    up = torch.einsum("bhwkuv,bhwkc->bhwuvc", mask, neigh)
    return up.permute(0, 1, 3, 2, 4, 5).reshape(B, h * 8, w * 8, 2)


def raft_flow(w: Weights, image1: torch.Tensor, image2: torch.Tensor,
              iters: int = 12) -> torch.Tensor:
    """Optical flow image1 -> image2 ([B, H, W, 3] in [0, 1], H and W
    multiples of 8) at full resolution, [B, H, W, 2].

    On the card the convolutions skip cuDNN: in fp32 without TF32 its
    heuristics gave several of RAFT's convs an FFT-tiling algorithm that
    made E*warp of a 720p clip about 19x slower than PyTorch's own
    convolutions, and two processes that took cuDNN scored one clip 9.2e-7
    apart (chip_smoke.py phase 21 times a pass both ways; PERF.md)."""
    with torch.backends.cudnn.flags(enabled=False):
        return _raft_flow(w, image1, image2, iters)


def _raft_flow(w: Weights, image1: torch.Tensor, image2: torch.Tensor,
               iters: int) -> torch.Tensor:
    B, H, W, _ = image1.shape
    if H % 8 or W % 8:
        raise ValueError(f"RAFT needs H, W divisible by 8, got {H}x{W}")
    x1 = (image1 * 2.0 - 1.0).permute(0, 3, 1, 2)
    x2 = (image2 * 2.0 - 1.0).permute(0, 3, 1, 2)
    f = encoder(w, "fnet", torch.cat([x1, x2]))
    pyramid = corr_pyramid(f[:B], f[B:])
    del f
    ctx = encoder(w, "cnet", x1)
    hidden = w["update_block.gru.convz1.weight"].shape[0]
    net, inp = torch.tanh(ctx[:, :hidden]), F.relu(ctx[:, hidden:])
    h, wd = ctx.shape[2:]
    coords0 = _grid(B, h, wd, ctx.device)
    coords1, mask = coords0, None
    for _ in range(iters):
        corr = corr_lookup(pyramid, coords1)
        flow = (coords1 - coords0).permute(0, 3, 1, 2)
        net, delta, mask = _update(w, net, inp, corr, flow)
        coords1 = coords1 + delta.permute(0, 2, 3, 1)
    if mask is None:
        mask = torch.zeros(B, h, wd, 9 * 64, device=ctx.device)
    else:
        mask = mask.permute(0, 2, 3, 1)
    return upsample_flow(coords1 - coords0, mask)


# ---------------------------------------------------------------------------
# Weights
# ---------------------------------------------------------------------------

def convert_raft(sd: Mapping[str, Any], device="cpu") -> Weights:
    """princeton-vl raft-things.pth state dict -> the fp32 weights on
    ``device`` ('module.' prefixes stripped; BatchNorm step counters and the
    downsample's second copy of norm3 dropped)."""
    out = {}
    for k, v in sd.items():
        k = k.removeprefix("module.")
        if k.endswith("num_batches_tracked") or ".downsample.1." in k:
            continue
        out[k] = torch.from_numpy(np.array(v, np.float32)).to(device)
    return out


def load_raft(path: str | Path, device="cpu") -> Weights:
    sd = torch.load(str(path), map_location="cpu", weights_only=True)
    return convert_raft({k: v.numpy() for k, v in sd.items()}, device)


def from_jax_raft(params: Mapping[str, Any], device="cpu") -> Weights:
    """The JAX package's tree (``init_raft_params`` / ``convert_raft``'s,
    NumPy leaves, HWIO kernels) -> the weights under raft-things' names."""
    out: dict[str, np.ndarray] = {}

    def put_conv(name, p):
        out[f"{name}.weight"] = np.transpose(np.asarray(p["kernel"]), (3, 2, 0, 1))
        if "bias" in p:
            out[f"{name}.bias"] = np.asarray(p["bias"])

    def put_norm(name, p):
        for ours, theirs in (("weight", "scale"), ("bias", "bias"),
                             ("running_mean", "mean"), ("running_var", "var")):
            if theirs in p:
                out[f"{name}.{ours}"] = np.asarray(p[theirs])

    for net in ("fnet", "cnet"):
        enc = params[net]
        put_conv(f"{net}.conv1", enc["conv1"])
        put_conv(f"{net}.conv2", enc["conv2"])
        if "norm1" in enc:
            put_norm(f"{net}.norm1", enc["norm1"])
        for i in (1, 2, 3):
            for j, blk in enumerate(enc[f"layer{i}"]):
                pre = f"{net}.layer{i}.{j}"
                put_conv(f"{pre}.conv1", blk["conv1"])
                put_conv(f"{pre}.conv2", blk["conv2"])
                if "downsample" in blk:
                    put_conv(f"{pre}.downsample.0", blk["downsample"])
                for n in (1, 2, 3):
                    if f"norm{n}" in blk:
                        put_norm(f"{pre}.norm{n}", blk[f"norm{n}"])
    up = params["update"]
    for k, p in up["encoder"].items():
        put_conv(f"update_block.encoder.{k}", p)
    for k, p in up["gru"].items():  # convz_h -> convz1, convz_v -> convz2
        gate, axis = k.split("_")
        put_conv(f"update_block.gru.{gate}{'1' if axis == 'h' else '2'}", p)
    put_conv("update_block.flow_head.conv1", up["flow_head"]["conv1"])
    put_conv("update_block.flow_head.conv2", up["flow_head"]["conv2"])
    put_conv("update_block.mask.0", up["mask"]["conv1"])
    put_conv("update_block.mask.2", up["mask"]["conv2"])
    return convert_raft(out, device)
