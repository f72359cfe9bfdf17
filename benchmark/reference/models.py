"""Plain float32 CogVideoX DiT and causal 3D VAE: the benchmark's reference.

Written from the published architecture (diffusers' ``CogVideoXTransformer3DModel``
and ``AutoencoderKLCogVideoX``, as DOVE runs them) in plain PyTorch: no kernel,
no cache, no quantization, no parallelism, and nothing of the program under
test. The parameters are a flat ``{name: tensor}`` dict under the diffusers
checkpoint names (:func:`dit_spec`, :func:`vae_spec`), read in whatever dtype
they were made in and computed in float32. Call :func:`strict_fp32` first on
the card, so that no float32 product runs in TF32.

Layouts: the DiT takes latents [B, F, C, H, W]; the VAE runs NCDHW. A causal
conv pads its clip's start with copies of the first frame; the whole clip is
one pass (the program's frame chunks with conv caches compute the same).
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

Params = dict[str, torch.Tensor]


def strict_fp32() -> None:
    """No TF32 in float32 matmuls and convolutions."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


# ---------------------------------------------------------------------------
# Parameter names and shapes (diffusers' checkpoint layout)
# ---------------------------------------------------------------------------

def sample_grid(c: dict) -> tuple[int, int, int]:
    return ((c["sample_frames"] - 1) // c["temporal_compression_ratio"] + 1,
            c["sample_height"] // c["patch_size"], c["sample_width"] // c["patch_size"])


def dit_spec(c: dict) -> list[tuple[str, tuple[int, ...]]]:
    """(name, shape) of every DiT tensor; ``c`` holds the transformer config."""
    D = c["num_attention_heads"] * c["attention_head_dim"]
    T, p, pt = c["time_embed_dim"], c["patch_size"], c["patch_size_t"]
    spec: list[tuple[str, tuple[int, ...]]] = []

    def lin(name: str, d_out: int, d_in: int, bias: bool = True) -> None:
        spec.append((f"{name}.weight", (d_out, d_in)))
        if bias:
            spec.append((f"{name}.bias", (d_out,)))

    def norm(name: str, dim: int) -> None:
        spec.extend([(f"{name}.weight", (dim,)), (f"{name}.bias", (dim,))])

    if pt is None:  # CogVideoX-1.0 (2B): a stride-p conv2d over each frame
        spec += [("patch_embed.proj.weight", (D, c["in_channels"], p, p)),
                 ("patch_embed.proj.bias", (D,))]
        t, h, w = sample_grid(c)
        spec.append(("patch_embed.pos_embedding",
                     (1, c["max_text_seq_length"] + t * h * w, D)))
    else:
        lin("patch_embed.proj", D, c["in_channels"] * pt * p * p, c["patch_bias"])
    lin("patch_embed.text_proj", D, c["text_embed_dim"])
    lin("time_embedding.linear_1", T, D)
    lin("time_embedding.linear_2", T, T)
    for i in range(c["num_layers"]):
        b = f"transformer_blocks.{i}"
        lin(f"{b}.norm1.linear", 6 * D, T)
        norm(f"{b}.norm1.norm", D)
        for t_ in ("to_q", "to_k", "to_v"):
            lin(f"{b}.attn1.{t_}", D, D, c["attention_bias"])
        lin(f"{b}.attn1.to_out.0", D, D)
        norm(f"{b}.attn1.norm_q", c["attention_head_dim"])
        norm(f"{b}.attn1.norm_k", c["attention_head_dim"])
        lin(f"{b}.norm2.linear", 6 * D, T)
        norm(f"{b}.norm2.norm", D)
        lin(f"{b}.ff.net.0.proj", D * c["ff_mult"], D)
        lin(f"{b}.ff.net.2", D, D * c["ff_mult"])
    norm("norm_final", D)
    lin("norm_out.linear", 2 * D, T)
    norm("norm_out.norm", D)
    lin("proj_out", c["out_channels"] * (pt or 1) * p * p, D)
    return spec


def vae_spec(c: dict) -> list[tuple[str, tuple[int, ...]]]:
    """(name, shape) of every VAE tensor; ``c`` holds the VAE config."""
    ch, lat, zq = list(c["block_out_channels"]), c["latent_channels"], c["latent_channels"]
    n = len(ch)
    spec: list[tuple[str, tuple[int, ...]]] = []

    def conv(name: str, c_out: int, c_in: int, k: tuple[int, ...]) -> None:
        spec.extend([(f"{name}.weight", (c_out, c_in) + k), (f"{name}.bias", (c_out,))])

    def gn(name: str, dim: int, spatial: bool) -> None:
        if not spatial:
            spec.extend([(f"{name}.weight", (dim,)), (f"{name}.bias", (dim,))])
            return
        spec.extend([(f"{name}.norm_layer.weight", (dim,)),
                     (f"{name}.norm_layer.bias", (dim,))])
        conv(f"{name}.conv_y.conv", dim, zq, (1, 1, 1))
        conv(f"{name}.conv_b.conv", dim, zq, (1, 1, 1))

    def res(name: str, c_in: int, c_out: int, spatial: bool) -> None:
        gn(f"{name}.norm1", c_in, spatial)
        conv(f"{name}.conv1.conv", c_out, c_in, (3, 3, 3))
        gn(f"{name}.norm2", c_out, spatial)
        conv(f"{name}.conv2.conv", c_out, c_out, (3, 3, 3))
        if c_in != c_out:
            conv(f"{name}.conv_shortcut", c_out, c_in, (1, 1, 1))

    conv("encoder.conv_in.conv", ch[0], c["in_channels"], (3, 3, 3))
    for i in range(n):
        for j in range(c["layers_per_block"]):
            res(f"encoder.down_blocks.{i}.resnets.{j}",
                ch[max(i - 1, 0)] if j == 0 else ch[i], ch[i], False)
        if i < n - 1:
            conv(f"encoder.down_blocks.{i}.downsamplers.0.conv", ch[i], ch[i], (3, 3))
    for j in range(2):
        res(f"encoder.mid_block.resnets.{j}", ch[-1], ch[-1], False)
    gn("encoder.norm_out", ch[-1], False)
    conv("encoder.conv_out.conv", 2 * lat, ch[-1], (3, 3, 3))

    rev = ch[::-1]
    conv("decoder.conv_in.conv", rev[0], lat, (3, 3, 3))
    for j in range(2):
        res(f"decoder.mid_block.resnets.{j}", rev[0], rev[0], True)
    for i in range(n):
        for j in range(c["layers_per_block"] + 1):
            res(f"decoder.up_blocks.{i}.resnets.{j}",
                rev[max(i - 1, 0)] if j == 0 else rev[i], rev[i], True)
        if i < n - 1:
            conv(f"decoder.up_blocks.{i}.upsamplers.0.conv", rev[i], rev[i], (3, 3))
    gn("decoder.norm_out", rev[-1], True)
    conv("decoder.conv_out.conv", c["out_channels"], rev[-1], (3, 3, 3))
    return spec


# ---------------------------------------------------------------------------
# Positions and the schedule
# ---------------------------------------------------------------------------

def _rope_1d(dim: int, length: int, theta: float) -> tuple[np.ndarray, np.ndarray]:
    freqs = 1.0 / (theta ** (np.arange(0, dim, 2, dtype=np.float64) / dim))
    angles = np.outer(np.arange(length, dtype=np.float64), freqs)
    return np.repeat(np.cos(angles), 2, axis=1), np.repeat(np.sin(angles), 2, axis=1)


def rope_3d(head_dim: int, t: int, h: int, w: int, theta: float, device):
    """diffusers' ``get_3d_rotary_pos_embed(grid_type="slice")``: (cos, sin)
    [t*h*w, head_dim], bands of D/4 (time), 3D/8 (height), 3D/8 (width),
    pairs interleaved, token order time-major."""
    dims = (head_dim // 4, head_dim // 8 * 3, head_dim // 8 * 3)
    tabs = [_rope_1d(d, n, theta) for d, n in zip(dims, (t, h, w))]
    out = []
    for k in range(2):
        a = np.broadcast_to(tabs[0][k][:, None, None], (t, h, w, dims[0]))
        b = np.broadcast_to(tabs[1][k][None, :, None], (t, h, w, dims[1]))
        c = np.broadcast_to(tabs[2][k][None, None, :], (t, h, w, dims[2]))
        out.append(torch.tensor(np.concatenate([a, b, c], -1).reshape(-1, head_dim),
                                dtype=torch.float32, device=device))
    return out


def rotate(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """Rotary embedding on interleaved (even, odd) lanes."""
    x2 = x.unflatten(-1, (-1, 2))
    rot = torch.stack([-x2[..., 1], x2[..., 0]], dim=-1).flatten(-2)
    return x * cos + rot * sin


def _sincos_1d(dim: int, pos: np.ndarray) -> np.ndarray:
    omega = 1.0 / (10000.0 ** (np.arange(dim // 2, dtype=np.float64) / (dim / 2.0)))
    out = np.outer(pos.reshape(-1), omega)
    return np.concatenate([np.sin(out), np.cos(out)], axis=-1)


def sincos_3d(dim: int, t: int, h: int, w: int, s_scale: float, t_scale: float):
    """diffusers' ``get_3d_sincos_pos_embed``: [t*h*w, dim] float64, the
    temporal quarter first, then the width and height halves of the rest."""
    ds, dt = 3 * dim // 4, dim // 4
    gw, gh = np.meshgrid(np.arange(w) / s_scale, np.arange(h) / s_scale)
    spatial = np.concatenate([_sincos_1d(ds // 2, gw), _sincos_1d(ds // 2, gh)], -1)
    temporal = _sincos_1d(dt, np.arange(t) / t_scale)
    spatial = np.repeat(spatial[None], t, axis=0)
    temporal = np.repeat(temporal[:, None], h * w, axis=1)
    return np.concatenate([temporal, spatial], -1).reshape(-1, dim)


def alphas_cumprod(s: dict) -> np.ndarray:
    """CogVideoX's alpha-bar: scaled-linear betas, SNR shift, zero terminal
    SNR rescale; float64."""
    n = s["num_train_timesteps"]
    if s["beta_schedule"] != "scaled_linear":
        raise ValueError(f"beta_schedule {s['beta_schedule']!r} is not in the reference")
    betas = np.linspace(s["beta_start"] ** 0.5, s["beta_end"] ** 0.5, n) ** 2
    abar = np.cumprod(1.0 - betas)
    k = s["snr_shift_scale"]
    abar = abar / (k + (1.0 - k) * abar)
    if s["rescale_betas_zero_snr"]:
        r = np.sqrt(abar)
        r = (r - r[-1]) * (r[0] / (r[0] - r[-1]))
        abar = r ** 2
    return abar


# ---------------------------------------------------------------------------
# The DiT
# ---------------------------------------------------------------------------
def _fp8(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to float8 e4m3, scaled by its largest magnitude to the
    format's 448; rounded forward, gradient straight through."""
    s = t.detach().abs().amax().clamp_min(1e-30) / 448.0
    return t + ((t / s).to(torch.float8_e4m3fn).to(torch.float32) * s - t).detach()


def fp8_linear(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor | None) -> torch.Tensor:
    """A linear layer with its input and weight rounded to float8 e4m3,
    computed in float32: the control's precision for a bfloat16 model."""
    y = F.linear(_fp8(x), _fp8(w))
    return y if b is None else y + b


def fp8_conv3d(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor | None, **kw) -> torch.Tensor:
    """``F.conv3d`` with its input and weight rounded to float8 e4m3,
    computed in float32: the VAE's control."""
    return F.conv3d(_fp8(x), _fp8(w), b, **kw)


def int4_linear(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor | None) -> torch.Tensor:
    """A linear layer on symmetric int4 codes (-7..7): the weight per output
    channel, the input per token, each scaled by its largest magnitude,
    computed in float32: the control's precision for an int8 model."""
    def q(t):
        s = t.abs().amax(dim=-1, keepdim=True).clamp_min(1e-30) / 7.0
        return torch.round(t / s).clamp(-7, 7) * s
    y = F.linear(q(x), q(w))
    return y if b is None else y + b



def _ln(x: torch.Tensor, P: Params, name: str, eps: float) -> torch.Tensor:
    return F.layer_norm(x, x.shape[-1:], P[f"{name}.weight"].float(),
                        P[f"{name}.bias"].float(), eps)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              chunk: int = 1024) -> torch.Tensor:
    """softmax(q k^T / sqrt(D)) v over [B, H, S, D], query rows in chunks."""
    kt = k.transpose(-1, -2) * (q.shape[-1] ** -0.5)
    outs = [torch.softmax(q[:, :, s:s + chunk] @ kt, dim=-1) @ v
            for s in range(0, q.shape[2], chunk)]
    return torch.cat(outs, dim=2)


class DiT:
    """The CogVideoX transformer over a parameter dict, in float32.

    ``linear(x, w, b)`` computes every linear layer (the fp8 control swaps it);
    ``lora`` ({target: {"A": [L, in, r], "B": [L, r, out]}}) is added to the
    q, k, v and out projections as ``W + scale * (A @ B)^T``."""

    def __init__(self, P: Params, c: dict, linear=None, lora=None, lora_scale=1.0,
                 remat: bool = False, chunk: int = 1024):
        self.P, self.c = P, c
        self.linear = linear or F.linear
        self.lora, self.lora_scale = lora, lora_scale
        self.remat, self.chunk = remat, chunk

    def lin(self, x, name, weight=None):
        w = self.P[f"{name}.weight"].float() if weight is None else weight
        b = self.P.get(f"{name}.bias")
        return self.linear(x, w, None if b is None else b.float())

    def _proj(self, x, i, target, name):
        w = self.P[f"{name}.weight"].float()
        if self.lora is not None and target in self.lora:
            a, b = self.lora[target]["A"][i], self.lora[target]["B"][i]
            w = w + self.lora_scale * (a.float() @ b.float()).T
        return self.lin(x, name, w)

    def block(self, i, hidden, encoder, temb, rope):
        c, pre = self.c, f"transformer_blocks.{i}"
        L, eps = encoder.shape[1], c["norm_eps"]
        B, hd = hidden.shape[0], c["attention_head_dim"]

        def modulate(n):
            m = self.lin(F.silu(temb), f"{pre}.{n}.linear")[:, None].chunk(6, dim=-1)
            h = _ln(hidden, self.P, f"{pre}.{n}.norm", eps) * (1 + m[1]) + m[0]
            e = _ln(encoder, self.P, f"{pre}.{n}.norm", eps) * (1 + m[4]) + m[3]
            return torch.cat([e, h], dim=1), m[2], m[5]

        x, gate, e_gate = modulate("norm1")
        S = x.shape[1]

        def heads(t, norm):
            t = t.view(B, S, -1, hd).transpose(1, 2)
            return _ln(t, self.P, f"{pre}.attn1.{norm}", c["qk_norm_eps"])

        a = f"{pre}.attn1"
        q = heads(self._proj(x, i, "to_q", f"{a}.to_q"), "norm_q")
        k = heads(self._proj(x, i, "to_k", f"{a}.to_k"), "norm_k")
        v = self._proj(x, i, "to_v", f"{a}.to_v").view(B, S, -1, hd).transpose(1, 2)
        if rope is not None:
            q = torch.cat([q[:, :, :L], rotate(q[:, :, L:], *rope)], dim=2)
            k = torch.cat([k[:, :, :L], rotate(k[:, :, L:], *rope)], dim=2)
        o = attention(q, k, v, self.chunk).transpose(1, 2).reshape(B, S, -1)
        o = self._proj(o, i, "to_out", f"{a}.to_out.0")
        hidden = hidden + gate * o[:, L:]
        encoder = encoder + e_gate * o[:, :L]

        x, gate, e_gate = modulate("norm2")
        ff = self.lin(F.gelu(self.lin(x, f"{pre}.ff.net.0.proj"), approximate="tanh"),
                      f"{pre}.ff.net.2")
        return hidden + gate * ff[:, L:], encoder + e_gate * ff[:, :L]

    def __call__(self, latent: torch.Tensor, text: torch.Tensor, t: int) -> torch.Tensor:
        """latent [B, F, C, H, W] (F a multiple of patch_size_t), text [B, L,
        text_dim], one timestep -> velocity [B, F, C_out, H, W], float32."""
        c, P = self.c, self.P
        B, Fr, C, H, W = latent.shape
        p, pt = c["patch_size"], c["patch_size_t"]
        D = c["num_attention_heads"] * c["attention_head_dim"]
        half = D // 2
        expo = (-math.log(10000.0) * torch.arange(half, dtype=torch.float64)
                / (half - c["freq_shift"]))
        ang = (float(t) * torch.exp(expo)).float().to(latent.device)
        feat = torch.cat([torch.cos(ang), torch.sin(ang)] if c["flip_sin_to_cos"]
                         else [torch.sin(ang), torch.cos(ang)])[None].expand(B, -1)
        temb = self.lin(F.silu(self.lin(feat, "time_embedding.linear_1")),
                        "time_embedding.linear_2")
        grid = (Fr // (pt or 1), H // p, W // p)
        if pt is None:
            x = F.conv2d(latent.reshape(B * Fr, C, H, W),
                         P["patch_embed.proj.weight"].float(),
                         P["patch_embed.proj.bias"].float(), stride=p)
            hidden = x.reshape(B, Fr, D, -1).permute(0, 1, 3, 2).reshape(B, -1, D)
        else:
            x = latent.reshape(B, Fr // pt, pt, C, H // p, p, W // p, p)
            x = x.permute(0, 1, 4, 6, 3, 2, 5, 7).reshape(B, -1, C * pt * p * p)
            hidden = self.lin(x, "patch_embed.proj")
        encoder = self.lin(text, "patch_embed.text_proj")
        rope = None
        if c["use_rotary_positional_embeddings"]:
            rope = rope_3d(c["attention_head_dim"], *grid, c["rope_theta"], latent.device)
        else:
            if grid == sample_grid(c):
                raise NotImplementedError("the stored table at the sample grid")
            table = sincos_3d(D, *grid, c["spatial_interpolation_scale"],
                              c["temporal_interpolation_scale"])
            hidden = hidden + torch.tensor(table, dtype=torch.float32,
                                           device=latent.device)[None]
        for i in range(c["num_layers"]):
            if self.remat and torch.is_grad_enabled():
                hidden, encoder = checkpoint(self.block, i, hidden, encoder, temb, rope,
                                             use_reentrant=False)
            else:
                hidden, encoder = self.block(i, hidden, encoder, temb, rope)
        eps = c["norm_eps"]
        if rope is not None:
            hidden = _ln(torch.cat([encoder, hidden], 1), P, "norm_final", eps)
            hidden = hidden[:, encoder.shape[1]:]
        else:
            hidden = _ln(hidden, P, "norm_final", eps)
        shift, scale = self.lin(F.silu(temb), "norm_out.linear").chunk(2, dim=-1)
        hidden = _ln(hidden, P, "norm_out.norm", eps) * (1 + scale[:, None]) + shift[:, None]
        out = self.lin(hidden, "proj_out")
        f, h, w = grid
        ptt = pt or 1
        out = out.reshape(B, f, h, w, -1, ptt, p, p).permute(0, 1, 5, 4, 2, 6, 3, 7)
        return out.reshape(B, Fr, -1, H, W)


def one_step_x0(dit: DiT, c_dit: dict, abar: np.ndarray, latent: torch.Tensor,
                text: torch.Tensor, t: int) -> torch.Tensor:
    """DOVE's one step: scaled latent [B, F', h, w, C] -> x-hat_0, same
    layout. The latent is front-padded with its first frame to whole temporal
    patches; x0 = sqrt(abar_t) z - sqrt(1 - abar_t) v."""
    pt = c_dit["patch_size_t"]
    pad = 0 if pt is None else (pt - latent.shape[1] % pt) % pt
    if pad:
        latent = torch.cat([latent[:, :1].expand(-1, pad, -1, -1, -1), latent], dim=1)
    z = latent.permute(0, 1, 4, 2, 3)
    v = dit(z, text, t)
    x0 = math.sqrt(abar[t]) * z - math.sqrt(1.0 - abar[t]) * v
    return x0[:, pad:].permute(0, 1, 3, 4, 2)


# ---------------------------------------------------------------------------
# The VAE (NCDHW, whole clips)
# ---------------------------------------------------------------------------

class VAE:
    def __init__(self, P: Params, c: dict, conv3d=None):
        """``conv3d(x, w, b, **kw)`` computes every convolution (the fp8
        control swaps it)."""
        self.P, self.c = P, c
        self.conv3d = conv3d or F.conv3d
        self.levels = len(c["block_out_channels"])
        self.t_levels = int(math.log2(c["temporal_compression_ratio"]))

    def w(self, name):
        return self.P[f"{name}.weight"].float(), self.P[f"{name}.bias"].float()

    def conv(self, x, name):
        """Causal conv: first-frame replicate in time, zero pad in space."""
        w, b = self.w(name)
        kt, kh, kw = w.shape[2:]
        if kt > 1:
            x = torch.cat([x[:, :, :1].expand(-1, -1, kt - 1, -1, -1), x], dim=2)
        return self.conv3d(x, w, b, padding=(0, kh // 2, kw // 2))

    def gn(self, x, name):
        w, b = self.w(name)
        return F.group_norm(x, self.c["norm_num_groups"], w, b, self.c["norm_eps"])

    @staticmethod
    def nearest(z, f, h, w):
        """Nearest upsample to (f, h, w); an odd f > 1 takes the first frame alone."""
        def up(t, n):
            return F.interpolate(t, size=(n, h, w), mode="nearest")
        if f > 1 and f % 2 == 1:
            return torch.cat([up(z[:, :, :1], 1), up(z[:, :, 1:], f - 1)], dim=2)
        return up(z, f)

    def norm(self, x, name, zq):
        if zq is None:
            return self.gn(x, name)
        y = self.nearest(self.conv(zq, f"{name}.conv_y.conv"), *x.shape[2:])
        b = self.nearest(self.conv(zq, f"{name}.conv_b.conv"), *x.shape[2:])
        return self.gn(x, f"{name}.norm_layer") * y + b

    def res(self, x, name, zq=None):
        h = self.conv(F.silu(self.norm(x, f"{name}.norm1", zq)), f"{name}.conv1.conv")
        h = self.conv(F.silu(self.norm(h, f"{name}.norm2", zq)), f"{name}.conv2.conv")
        if f"{name}.conv_shortcut.weight" in self.P:
            x = self.conv(x, f"{name}.conv_shortcut")
        return x + h

    def frame_conv(self, x, name, stride, pad):
        w, b = self.w(name)
        return self.conv3d(x, w[:, :, None], b, stride=(1, stride, stride),
                        padding=(0, pad, pad))

    def encode(self, x: torch.Tensor) -> torch.Tensor:
        """Pixels [B, 3, F, H, W] in [-1, 1] -> moments [B, 2C, F', H/8, W/8]."""
        h = self.conv(x, "encoder.conv_in.conv")
        for i in range(self.levels):
            for j in range(self.c["layers_per_block"]):
                h = self.res(h, f"encoder.down_blocks.{i}.resnets.{j}")
            if i < self.levels - 1:
                if i < self.t_levels:  # 2x temporal mean, the odd first frame alone
                    B, C, Fr, H, W = h.shape
                    first, rest = (h[:, :, :1], h[:, :, 1:]) if Fr % 2 else (h[:, :, :0], h)
                    rest = rest.reshape(B, C, rest.shape[2] // 2, 2, H, W).mean(3)
                    h = torch.cat([first, rest], dim=2)
                h = self.frame_conv(F.pad(h, (0, 1, 0, 1)),
                                    f"encoder.down_blocks.{i}.downsamplers.0.conv", 2, 0)
        for j in range(2):
            h = self.res(h, f"encoder.mid_block.resnets.{j}")
        return self.conv(F.silu(self.gn(h, "encoder.norm_out")), "encoder.conv_out.conv")

    def decode(self, z: torch.Tensor) -> torch.Tensor:
        """Unscaled latent [B, C, F', h, w] -> pixels [B, 3, F, H, W]."""
        h = self.conv(z, "decoder.conv_in.conv")
        for j in range(2):
            h = self.res(h, f"decoder.mid_block.resnets.{j}", z)
        for i in range(self.levels):
            for j in range(self.c["layers_per_block"] + 1):
                h = self.res(h, f"decoder.up_blocks.{i}.resnets.{j}", z)
            if i < self.levels - 1:
                _, _, Fr, H, W = h.shape
                f = (1 + 2 * (Fr - 1) if Fr % 2 else 2 * Fr) if i < self.t_levels else Fr
                h = self.frame_conv(self.nearest(h, f, 2 * H, 2 * W),
                                    f"decoder.up_blocks.{i}.upsamplers.0.conv", 1, 1)
        h = F.silu(self.norm(h, "decoder.norm_out", z))
        return self.conv(h, "decoder.conv_out.conv")
