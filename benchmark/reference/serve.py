"""The staged one-step 4x clip (the reference's ``--is_vae_st``), in float32.

Works out again, from the clip, the weights and the seed, what the program's
staged path computes: padding to the causal-VAE frame rule and to multiples
of 16 pixels, the 4x bilinear upscale, the VAE encode over feathered spatial
windows, the posterior sample from a generator seeded with the clip's seed,
one DiT pass at ``sr_noise_step`` and the x0 formula, the windowed decode and
the uint8 quantisation. Clips of up to 33 frames (one pass).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from benchmark.reference.models import DiT, VAE, alphas_cumprod, one_step_x0

MAX_FRAMES = 33
# (blend, encode window cap (h, w), decode window cap (h, w)) in latents by
# serving mode: the window plans DOVE's staged path takes for a 16 GB device
WINDOW_BUDGET = {
    None: (2, (32, 32), (28, 28)),
    "int8w": (2, (40, 38), (36, 34)),
    "int8-dit": (2, (40, 38), (36, 34)),
}


def padding(frames: int, h: int, w: int) -> tuple[int, int, int]:
    """(pad_f, pad_h, pad_w): (F - 1) % 8 == 0, H and W multiples of 16."""
    return (-(frames - 1)) % 8, (-h) % 16, (-w) % 16


def plan_axis(size: int, blend: int, max_tile: int) -> tuple[int, int, int]:
    """The fewest windows of at most ``max_tile`` with a ``blend`` band:
    (tile, stride, n)."""
    if size <= max_tile:
        return size, size, 1
    n = -(-(size - blend) // (max_tile - blend))
    tile = min(-(-(size - blend) // n) + blend, max_tile)
    return tile, tile - blend, n


def assemble(tiles, n_rows, n_cols, blend_h, blend_w, out_h, out_w):
    """Row-major windows [..., th, tw, C] -> [..., out_h, out_w, C]: each
    window's leading band is lerped with its upper / left neighbour's
    trailing band; the last row and column keep their whole extent."""
    th, tw = tiles[0].shape[-3], tiles[0].shape[-2]
    ha, wa = tiles[0].ndim - 3, tiles[0].ndim - 2

    def lerp(a, b, n, axis):
        shape = [1] * b.ndim
        shape[axis] = n
        w = (torch.arange(n, dtype=torch.float32, device=b.device) / n).reshape(shape)
        return a * (1 - w) + b * w

    rows, prev = [], None
    for r in range(n_rows):
        row, out_row = tiles[r * n_cols:(r + 1) * n_cols], []
        for c, t in enumerate(row):
            if prev is not None and blend_h:
                band = lerp(prev[c].narrow(ha, th - blend_h, blend_h),
                            t.narrow(ha, 0, blend_h), blend_h, ha)
                t = torch.cat([band, t.narrow(ha, blend_h, th - blend_h)], dim=ha)
            if c and blend_w:
                band = lerp(row[c - 1].narrow(wa, tw - blend_w, blend_w),
                            t.narrow(wa, 0, blend_w), blend_w, wa)
                t = torch.cat([band, t.narrow(wa, blend_w, tw - blend_w)], dim=wa)
            out_row.append(t.narrow(ha, 0, th if r == n_rows - 1 else th - blend_h)
                           .narrow(wa, 0, tw if c == n_cols - 1 else tw - blend_w))
        rows.append(torch.cat(out_row, dim=wa))
        prev = row
    return torch.cat(rows, dim=ha).narrow(ha, 0, out_h).narrow(wa, 0, out_w)


def edge_pad(x: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """[B, F, H, W, C] edge-replicated to (h, w) at the bottom and right."""
    H, W = x.shape[2], x.shape[3]
    x = x.index_select(2, torch.arange(h, device=x.device).clamp_(max=H - 1))
    return x.index_select(3, torch.arange(w, device=x.device).clamp_(max=W - 1))


def windows(x, size_h, size_w, scale, blend, cap, fn, blend_out):
    """``fn`` over the window plan of a [1, F, size_h*scale, size_w*scale, C]
    input (sizes in latents), assembled with ``blend_out`` bands."""
    th, sh, nr = plan_axis(size_h, blend, cap[0])
    tw, sw, nc = plan_axis(size_w, blend, cap[1])
    if nr == 1 and nc == 1:
        return fn(x)
    x = edge_pad(x, ((nr - 1) * sh + th) * scale, ((nc - 1) * sw + tw) * scale)
    tiles = [fn(x[:, :, r * sh * scale:(r * sh + th) * scale,
                  c * sw * scale:(c * sw + tw) * scale])
             for r in range(nr) for c in range(nc)]
    k = blend_out // blend
    return assemble(tiles, nr, nc, blend_out if nr > 1 else 0, blend_out if nc > 1 else 0,
                    size_h * k, size_w * k)


@torch.no_grad()
def staged_clip(dit_params, vae_params, cfg: dict, frames01: np.ndarray,
                prompt: torch.Tensor, seed: int, quantize: str | None = None,
                linear=None, conv3d=None) -> np.ndarray:
    """frames01 [F, H, W, 3] float32 in [0, 1] -> uint8 [F, 4H, 4W, 3].

    ``cfg`` is the configuration file's dict; ``prompt`` [L, text_dim] the
    prompt embedding; ``quantize`` picks the serving mode's window plan (the
    arithmetic stays float32); ``linear`` replaces the DiT's linear layers,
    ``conv3d`` the VAE's convolutions."""
    c_dit, c_vae, u = cfg["dit"], cfg["vae"], cfg["upscale"]
    Fr, H, W, _ = frames01.shape
    if Fr + padding(Fr, H, W)[0] > MAX_FRAMES:
        raise ValueError(f"the reference runs clips of one pass (<= {MAX_FRAMES} frames)")
    device = prompt.device
    pf, ph, pw = padding(Fr, H, W)
    x = torch.as_tensor(frames01, dtype=torch.float32).to(device)
    x = torch.cat([x, x[-1:].expand(pf, -1, -1, -1)]) if pf else x
    x = F.pad(x, (0, 0, 0, pw, 0, ph)) * 2 - 1  # [F, Hp, Wp, 3]
    Fp, Hp, Wp, _ = x.shape
    up = F.interpolate(x.permute(0, 3, 1, 2), size=(Hp * u, Wp * u), mode="bilinear",
                       align_corners=False).permute(0, 2, 3, 1)[None]
    s = 2 ** (len(c_vae["block_out_channels"]) - 1)
    lat_h, lat_w = Hp * u // s, Wp * u // s
    blend, enc_cap, dec_cap = WINDOW_BUDGET[quantize]
    vae = VAE(vae_params, c_vae, conv3d)

    def enc(t):  # [1, F, h, w, 3] -> moments [1, F', h/8, w/8, 2C]
        return vae.encode(t.permute(0, 4, 1, 2, 3)).permute(0, 2, 3, 4, 1)

    moments = windows(up, lat_h, lat_w, s, blend, enc_cap, enc, blend)
    mean, logvar = moments.chunk(2, dim=-1)
    gen = torch.Generator(device=device).manual_seed(seed)
    eps = torch.randn(mean.shape, generator=gen, device=device, dtype=torch.float32)
    latent = (mean + torch.exp(0.5 * logvar.clamp(-30.0, 20.0)) * eps) * c_vae["scaling_factor"]
    del moments, mean, logvar, eps
    text = prompt.float()[None]
    x0 = one_step_x0(DiT(dit_params, c_dit, linear), c_dit, alphas_cumprod(cfg["scheduler"]),
                     latent, text, cfg["sr_noise_step"])
    z = x0 / c_vae["scaling_factor"]

    def dec(t):  # [1, F', h, w, C] -> pixels [1, F, 8h, 8w, 3]
        return vae.decode(t.permute(0, 4, 1, 2, 3)).permute(0, 2, 3, 4, 1)

    pixels = windows(z, lat_h, lat_w, 1, blend, dec_cap, dec, blend * s)
    out = torch.round((pixels * 0.5 + 0.5).clamp(0.0, 1.0) * 255.0).to(torch.uint8)[0]
    return out[:Fr, :H * u, :W * u].cpu().numpy()
