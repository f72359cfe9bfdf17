"""Wan2.1-T2V on DOVE's one-step 4x path, in plain float32 (TF32 off).

Works out again what the program's Wan route computes, from the clip, the
weights and the configuration file alone; it imports nothing of the program
and nothing of JAX. It follows the public code (github.com/Wan-AI/Wan2.1,
``wan/modules/model.py`` and ``wan/modules/vae.py``) as written there: the
VAE's chunks of 1, 4, 4, ... frames with a cache of 2 frames per causal
convolution, the temporal resamplers' first-chunk rules, the DiT's blocks
with RMS norms over all channels, 3-D RoPE and cross-attention to the
512-slot context, and one flow-matching step x0 = z - sigma u.

The weights arrive in the model dtype and are upcast layer by layer
(lossless), so the 14B holds 28.6 GB on the card, not 57. Self-attention
runs in blocks of query rows, every head at once.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from benchmark.reference.serve import MAX_FRAMES, padding

Params = dict
CACHE_T = 2
Q_ROWS = 1024  # query rows a block of the reference's self-attention


# ---------------------------------------------------------------------------
# Parameter names and shapes (the release's checkpoint layout)
# ---------------------------------------------------------------------------

def dit_spec(c: dict) -> list[tuple[str, tuple[int, ...]]]:
    d, f = c["dim"], c["ffn_dim"]
    pt, ph, pw = c["patch_size"]
    out: list[tuple[str, tuple[int, ...]]] = []

    def lin(name, d_out, d_in):
        out.extend([(f"{name}.weight", (d_out, d_in)), (f"{name}.bias", (d_out,))])

    out.extend([("patch_embedding.weight", (d, c["in_dim"], pt, ph, pw)),
                ("patch_embedding.bias", (d,))])
    lin("text_embedding.0", d, c["text_dim"])
    lin("text_embedding.2", d, d)
    lin("time_embedding.0", d, c["freq_dim"])
    lin("time_embedding.2", d, d)
    lin("time_projection.1", 6 * d, d)
    for i in range(c["num_layers"]):
        b = f"blocks.{i}"
        for a in ("self_attn", "cross_attn"):
            for p in ("q", "k", "v", "o"):
                lin(f"{b}.{a}.{p}", d, d)
            out.extend([(f"{b}.{a}.norm_q.weight", (d,)), (f"{b}.{a}.norm_k.weight", (d,))])
        out.extend([(f"{b}.norm3.weight", (d,)), (f"{b}.norm3.bias", (d,))])
        lin(f"{b}.ffn.0", f, d)
        lin(f"{b}.ffn.2", d, f)
        out.append((f"{b}.modulation", (1, 6, d)))
    lin("head.head", pt * ph * pw * c["out_dim"], d)
    out.append(("head.modulation", (1, 2, d)))
    return out


def vae_layers(c: dict) -> list[tuple[str, str, int, int]]:
    """The VAE's layers in call order: (name, kind, c_in, c_out), kinds
    conv (k 3), res, attn, down2d, down3d, up2d, up3d, head, conv1x1."""
    dims = [c["base_dim"] * u for u in [1] + list(c["dim_mult"])]
    n = len(c["dim_mult"])
    L: list[tuple[str, str, int, int]] = [("encoder.conv1", "conv", 3, dims[0])]
    j = 0
    for i, (ci, co) in enumerate(zip(dims[:-1], dims[1:])):
        for _ in range(c["num_res_blocks"]):
            L.append((f"encoder.downsamples.{j}", "res", ci, co))
            ci, j = co, j + 1
        if i != n - 1:
            kind = "down3d" if c["temperal_downsample"][i] else "down2d"
            L.append((f"encoder.downsamples.{j}", kind, co, co))
            j += 1
    top = dims[-1]
    L += [("encoder.middle.0", "res", top, top), ("encoder.middle.1", "attn", top, top),
          ("encoder.middle.2", "res", top, top), ("encoder.head", "head", top, 2 * c["z_dim"]),
          ("conv1", "conv1x1", 2 * c["z_dim"], 2 * c["z_dim"]),
          ("conv2", "conv1x1", c["z_dim"], c["z_dim"])]
    mult = list(c["dim_mult"])
    dd = [c["base_dim"] * u for u in [mult[-1]] + mult[::-1]]
    up = list(c["temperal_downsample"])[::-1]
    L += [("decoder.conv1", "conv", c["z_dim"], dd[0]),
          ("decoder.middle.0", "res", dd[0], dd[0]), ("decoder.middle.1", "attn", dd[0], dd[0]),
          ("decoder.middle.2", "res", dd[0], dd[0])]
    j = 0
    for i, (ci, co) in enumerate(zip(dd[:-1], dd[1:])):
        if i in (1, 2, 3):
            ci //= 2
        for _ in range(c["num_res_blocks"] + 1):
            L.append((f"decoder.upsamples.{j}", "res", ci, co))
            ci, j = co, j + 1
        if i != n - 1:
            L.append((f"decoder.upsamples.{j}", "up3d" if up[i] else "up2d", co, co))
            j += 1
    L.append(("decoder.head", "head", dd[-1], 3))
    return L


def vae_spec(c: dict) -> list[tuple[str, tuple[int, ...]]]:
    out: list[tuple[str, tuple[int, ...]]] = []

    def conv(name, co, ci, k):
        out.extend([(f"{name}.weight", (co, ci) + k), (f"{name}.bias", (co,))])

    for name, kind, ci, co in vae_layers(c):
        if kind == "conv":
            conv(name, co, ci, (3, 3, 3))
        elif kind == "conv1x1":
            conv(name, co, ci, (1, 1, 1))
        elif kind == "res":
            out.append((f"{name}.residual.0.gamma", (ci, 1, 1, 1)))
            conv(f"{name}.residual.2", co, ci, (3, 3, 3))
            out.append((f"{name}.residual.3.gamma", (co, 1, 1, 1)))
            conv(f"{name}.residual.6", co, co, (3, 3, 3))
            if ci != co:
                conv(f"{name}.shortcut", co, ci, (1, 1, 1))
        elif kind == "attn":
            out.append((f"{name}.norm.gamma", (ci, 1, 1)))
            conv(f"{name}.to_qkv", 3 * ci, ci, (1, 1))
            conv(f"{name}.proj", ci, ci, (1, 1))
        elif kind == "head":
            out.append((f"{name}.0.gamma", (ci, 1, 1, 1)))
            conv(f"{name}.2", co, ci, (3, 3, 3))
        else:  # resamplers
            conv(f"{name}.resample.1", co // 2 if kind.startswith("up") else co, ci, (3, 3))
            if kind == "down3d":
                conv(f"{name}.time_conv", co, co, (3, 1, 1))
            elif kind == "up3d":
                conv(f"{name}.time_conv", 2 * co, co, (3, 1, 1))
    return out


# ---------------------------------------------------------------------------
# The DiT
# ---------------------------------------------------------------------------

def rope_freqs(c: dict, f: int, h: int, w: int, device) -> torch.Tensor:
    """Wan's complex multipliers [f h w, D / 2] (``rope_params`` of the
    three bands, ``rope_apply``'s split), float64 angles."""
    d = c["dim"] // c["num_heads"]
    bands = (d - 4 * (d // 6), 2 * (d // 6), 2 * (d // 6))

    def params(n, dim):
        ang = torch.outer(torch.arange(n, dtype=torch.float64),
                          1.0 / torch.pow(c.get("rope_theta", 10000.0),
                                          torch.arange(0, dim, 2, dtype=torch.float64) / dim))
        return torch.polar(torch.ones_like(ang), ang)

    ft, fh, fw = params(f, bands[0]), params(h, bands[1]), params(w, bands[2])
    return torch.cat([ft.view(f, 1, 1, -1).expand(f, h, w, -1),
                      fh.view(1, h, 1, -1).expand(f, h, w, -1),
                      fw.view(1, 1, w, -1).expand(f, h, w, -1)], dim=-1).reshape(f * h * w, -1).to(device)


def rope_apply(x: torch.Tensor, freqs: torch.Tensor) -> torch.Tensor:
    """x [S, H, D] -> rotated pairs (x_2j, x_2j+1), in float64 as Wan does."""
    S, H, D = x.shape
    xc = torch.view_as_complex(x.to(torch.float64).reshape(S, H, D // 2, 2))
    return torch.view_as_real(xc * freqs[:, None]).reshape(S, H, D).float()


class DiT:
    def __init__(self, P: Params, c: dict, linear=None):
        self.P, self.c = P, c
        self.linear = linear or (lambda x, w, b: F.linear(x, w, b))

    def w(self, name):
        return self.P[name].float()

    def lin(self, x, name):
        return self.linear(x, self.w(f"{name}.weight"), self.w(f"{name}.bias"))

    def rms(self, x, name):
        return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + self.c["eps"]) * self.w(name)

    def ln(self, x):
        return F.layer_norm(x, x.shape[-1:], eps=self.c["eps"])

    def attention(self, q, k, v):
        """q [Sq, H, D], k, v [Skv, H, D] -> [Sq, H D], softmax in fp32 over
        blocks of query rows."""
        q, k, v = q.transpose(0, 1), k.transpose(0, 1), v.transpose(0, 1)
        scale = q.shape[-1] ** -0.5
        out = torch.empty_like(q)
        kt = k.transpose(1, 2)
        for r in range(0, q.shape[1], Q_ROWS):
            s = torch.matmul(q[:, r:r + Q_ROWS], kt).mul_(scale)
            s.sub_(s.amax(-1, keepdim=True)).exp_()
            s.div_(s.sum(-1, keepdim=True))
            out[:, r:r + Q_ROWS] = torch.matmul(s, v)
            del s
        return out.transpose(0, 1).reshape(q.shape[1], -1)

    def __call__(self, z: torch.Tensor, context: torch.Tensor, t: int) -> torch.Tensor:
        """z [16, F, H, W] fp32, context [L, text_dim] -> u [16, F, H, W]."""
        c = self.c
        d, nh = c["dim"], c["num_heads"]
        hd = d // nh
        pt, ph, pw = c["patch_size"]
        Fz, H, W = z.shape[1:]
        f, h, w = Fz // pt, H // ph, W // pw
        x = F.conv3d(z[None], self.w("patch_embedding.weight"), self.w("patch_embedding.bias"),
                     stride=(pt, ph, pw))[0].flatten(1).T  # [S, dim]
        half = c["freq_dim"] // 2
        ang = t * torch.pow(10000.0, -torch.arange(half, dtype=torch.float64) / half)
        sinus = torch.cat([torch.cos(ang), torch.sin(ang)]).float().to(z.device)[None]
        e = self.lin(F.silu(self.lin(sinus, "time_embedding.0")), "time_embedding.2")
        e0 = self.lin(F.silu(e), "time_projection.1").view(6, d)
        ctx = F.pad(context.float(), (0, 0, 0, c["text_len"] - context.shape[0]))
        ctx = self.lin(F.gelu(self.lin(ctx, "text_embedding.0"), approximate="tanh"),
                       "text_embedding.2")
        freqs = rope_freqs(c, f, h, w, z.device)
        S, L = x.shape[0], ctx.shape[0]
        for i in range(c["num_layers"]):
            b = f"blocks.{i}"
            m = self.w(f"{b}.modulation")[0] + e0
            y = self.ln(x) * (1 + m[1]) + m[0]
            a = f"{b}.self_attn"
            q = rope_apply(self.rms(self.lin(y, f"{a}.q"), f"{a}.norm_q.weight").view(S, nh, hd), freqs)
            k = rope_apply(self.rms(self.lin(y, f"{a}.k"), f"{a}.norm_k.weight").view(S, nh, hd), freqs)
            v = self.lin(y, f"{a}.v").view(S, nh, hd)
            x = x + self.lin(self.attention(q, k, v), f"{a}.o") * m[2]
            del q, k, v, y
            a = f"{b}.cross_attn"
            y = F.layer_norm(x, x.shape[-1:], self.w(f"{b}.norm3.weight"),
                             self.w(f"{b}.norm3.bias"), c["eps"])
            q = self.rms(self.lin(y, f"{a}.q"), f"{a}.norm_q.weight").view(S, nh, hd)
            k = self.rms(self.lin(ctx, f"{a}.k"), f"{a}.norm_k.weight").view(L, nh, hd)
            v = self.lin(ctx, f"{a}.v").view(L, nh, hd)
            x = x + self.lin(self.attention(q, k, v), f"{a}.o")
            del q, k, v, y
            y = self.ln(x) * (1 + m[4]) + m[3]
            y = self.lin(F.gelu(self.lin(y, f"{b}.ffn.0"), approximate="tanh"), f"{b}.ffn.2")
            x = x + y * m[5]
            del y
        hm = self.w("head.modulation")[0] + e
        u = self.lin(self.ln(x) * (1 + hm[1]) + hm[0], "head.head")
        u = u.view(f, h, w, pt, ph, pw, c["out_dim"])
        return torch.einsum("fhwpqrc->cfphqwr", u).reshape(c["out_dim"], Fz, H, W)


# ---------------------------------------------------------------------------
# The VAE, chunk by chunk as the release runs it
# ---------------------------------------------------------------------------

class VAE:
    def __init__(self, P: Params, c: dict, conv3d=None):
        self.P, self.c = P, c
        self.conv3d = conv3d or F.conv3d
        self.layers = {name: (kind, ci, co) for name, kind, ci, co in vae_layers(c)}

    def w(self, name):
        return self.P[name].float()

    def conv(self, x, name, pad_hw=1, stride=1):
        w = self.w(f"{name}.weight")
        if w.ndim == 4:  # the release's per-frame Conv2d
            w = w[:, :, None]
        return self.conv3d(x, w, self.w(f"{name}.bias"), stride=(1, stride, stride) if
                           isinstance(stride, int) else stride, padding=(0, pad_hw, pad_hw))

    def causal(self, x, name, cache, idx, front=2):
        """A CausalConv3d of k 3 (front 2 frames), the release's cache rule."""
        cache_x = x[:, :, -CACHE_T:].clone()
        prev = cache[idx[0]]
        if cache_x.shape[2] < 2 and prev is not None:
            cache_x = torch.cat([prev[:, :, -1:], cache_x], 2)
        if prev is not None:
            x = torch.cat([prev, x], 2)
            front -= prev.shape[2]
        x = F.pad(x, (0, 0, 0, 0, front, 0))
        out = self.conv(x, name)
        cache[idx[0]] = cache_x
        idx[0] += 1
        return out

    def rms(self, x, name):
        g = self.w(f"{name}.gamma")
        return F.normalize(x, dim=1) * x.shape[1] ** 0.5 * g

    def res(self, x, name, cache, idx):
        _, ci, co = self.layers[name]
        h = self.conv(x, f"{name}.shortcut", 0) if ci != co else x
        y = self.causal(F.silu(self.rms(x, f"{name}.residual.0")), f"{name}.residual.2", cache, idx)
        y = self.causal(F.silu(self.rms(y, f"{name}.residual.3")), f"{name}.residual.6", cache, idx)
        return y + h

    def attn(self, x, name):
        b, c, t, h, w = x.shape
        y = x.transpose(1, 2).reshape(b * t, c, h, w)
        y = F.normalize(y, dim=1) * c ** 0.5 * self.w(f"{name}.norm.gamma")
        qkv = self.conv(y.reshape(b * t, c, 1, h, w), f"{name}.to_qkv", 0)[:, :, 0]
        q, k, v = qkv.reshape(b * t, 3 * c, h * w).transpose(1, 2).chunk(3, dim=-1)
        p = torch.softmax(torch.matmul(q, k.transpose(1, 2)) * c ** -0.5, dim=-1)
        o = torch.matmul(p, v).transpose(1, 2).reshape(b * t, c, 1, h, w)
        o = self.conv(o, f"{name}.proj", 0)[:, :, 0]
        return x + o.reshape(b, t, c, h, w).transpose(1, 2)

    def resample(self, x, name, kind, cache, idx):
        b, c, t, h, w = x.shape
        if kind == "up3d":
            prev = cache[idx[0]]
            if prev is None:
                cache[idx[0]] = "Rep"
                idx[0] += 1
            else:
                cache_x = x[:, :, -CACHE_T:].clone()
                if cache_x.shape[2] < 2 and not isinstance(prev, str):
                    cache_x = torch.cat([prev[:, :, -1:], cache_x], 2)
                if cache_x.shape[2] < 2 and isinstance(prev, str):
                    cache_x = torch.cat([torch.zeros_like(cache_x), cache_x], 2)
                xp = torch.cat([prev, x], 2) if not isinstance(prev, str) else F.pad(
                    x, (0, 0, 0, 0, 2, 0))
                x = self.conv(xp, f"{name}.time_conv", 0)
                cache[idx[0]] = cache_x
                idx[0] += 1
                x = x.reshape(b, 2, c, t, h, w)
                x = torch.stack((x[:, 0], x[:, 1]), 3).reshape(b, c, 2 * t, h, w)
        if kind.startswith("up"):
            x = x.repeat_interleave(2, dim=3).repeat_interleave(2, dim=4)
            return self.conv(x, f"{name}.resample.1", 1)
        x = self.conv(F.pad(x, (0, 1, 0, 1)), f"{name}.resample.1", 0, 2)
        if kind == "down3d":
            prev = cache[idx[0]]
            if prev is None:
                cache[idx[0]] = x.clone()
            else:
                cache_x = x[:, :, -1:].clone()
                x = self.conv(torch.cat([prev[:, :, -1:], x], 2), f"{name}.time_conv", 0,
                              (2, 1, 1))
                cache[idx[0]] = cache_x
            idx[0] += 1
        return x

    def run(self, x, part, cache, idx):
        for name, (kind, _, _) in self.layers.items():
            if not name.startswith(part):
                continue
            if kind == "conv":
                x = self.causal(x, name, cache, idx)
            elif kind == "res":
                x = self.res(x, name, cache, idx)
            elif kind == "attn":
                x = self.attn(x, name)
            elif kind == "head":
                x = self.causal(F.silu(self.rms(x, f"{name}.0")), f"{name}.2", cache, idx)
            else:
                x = self.resample(x, name, kind, cache, idx)
        return x

    def encode(self, x):
        """x [1, 3, T, H, W] -> mu [1, z, T', H/8, W/8]."""
        cache = [None] * 128
        outs = []
        for i in range(1 + (x.shape[2] - 1) // 4):
            idx = [0]
            xi = x[:, :, :1] if i == 0 else x[:, :, 1 + 4 * (i - 1):1 + 4 * i]
            outs.append(self.run(xi, "encoder.", cache, idx))
        out = self.conv(torch.cat(outs, 2), "conv1", 0)
        return out[:, :self.c["z_dim"]]

    def decode(self, z):
        """z [1, z, T', h, w] (unnormalised) -> pixels [1, 3, T, 8h, 8w]."""
        x = self.conv(z, "conv2", 0)
        cache = [None] * 128
        outs = []
        for i in range(x.shape[2]):
            idx = [0]
            outs.append(self.run(x[:, :, i:i + 1], "decoder.", cache, idx))
        return torch.cat(outs, 2)


@torch.no_grad()
def wan_clip(dit_params: Params, vae_params: Params, cfg: dict, frames01: np.ndarray,
             prompt: torch.Tensor, linear=None, conv3d=None) -> np.ndarray:
    """frames01 [F, H, W, 3] float32 in [0, 1] -> uint8 [F, 4H, 4W, 3]: the
    padding and 4x bilinear upscale of the staged path, the VAE's posterior
    mean normalised by the latent statistics, one DiT pass at
    ``sr_noise_step`` and x0 = z - sigma u (sigma = t / 1000), the decode
    clamped to [-1, 1]. ``prompt`` [L, text_dim]; ``linear`` replaces the
    DiT's linears, ``conv3d`` the VAE's convolutions."""
    c_dit, c_vae, u = cfg["dit"], cfg["vae"], cfg["upscale"]
    Fr, H, W, _ = frames01.shape
    pf, ph, pw = padding(Fr, H, W)
    if Fr + pf > MAX_FRAMES:
        raise ValueError(f"the reference runs clips of one pass (<= {MAX_FRAMES} frames)")
    device = prompt.device
    x = torch.as_tensor(frames01, dtype=torch.float32).to(device)
    x = torch.cat([x, x[-1:].expand(pf, -1, -1, -1)]) if pf else x
    x = F.pad(x, (0, 0, 0, pw, 0, ph)) * 2 - 1  # [F, Hp, Wp, 3]
    Hp, Wp = x.shape[1:3]
    up = F.interpolate(x.permute(0, 3, 1, 2), size=(Hp * u, Wp * u), mode="bilinear",
                       align_corners=False)  # [F, 3, H, W]
    vae = VAE(vae_params, c_vae, conv3d)
    mu = vae.encode(up.transpose(0, 1)[None])
    del up
    shape = (1, c_vae["z_dim"], 1, 1, 1)
    mean = torch.tensor(c_vae["latents_mean"], device=device).view(shape)
    std = torch.tensor(c_vae["latents_std"], device=device).view(shape)
    z = (mu - mean) / std
    t = cfg["sr_noise_step"]
    sigma = t / cfg["scheduler"]["num_train_timesteps"]
    uvel = DiT(dit_params, c_dit, linear)(z[0], prompt.float(), t)
    x0 = z[0] - sigma * uvel
    pixels = vae.decode((x0 * std[0] + mean[0])[None]).clamp(-1.0, 1.0)
    out = torch.round((pixels * 0.5 + 0.5) * 255.0).to(torch.uint8)[0]
    return out.permute(1, 2, 3, 0)[:Fr, :H * u, :W * u].cpu().numpy()

