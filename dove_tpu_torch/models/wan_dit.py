"""Wan2.1's text-to-video DiT (``WanModel``) as a PyTorch module.

The public code is ``wan/modules/model.py`` of github.com/Wan-AI/Wan2.1;
module and parameter names follow it (``blocks.{i}.self_attn.q.weight``,
``text_embedding.0.weight``, ``head.modulation``, ...), so a released state
dict loads with ``load_state_dict``. The port imports nothing of it.

Architecture: a (1, 2, 2) patch conv; the umT5 context through a GELU-tanh
MLP; the timestep's [cos | sin] features through a SiLU MLP to ``e``, and
``e0`` = Lin(SiLU(e)) as six modulation rows; then per block

  * self-attention: LN(x)(1 + m1) + m0 -> q, k, v (RMS norms over all
    ``dim`` channels on q and k), 3-D RoPE on q and k, full attention,
    ``x += o(.) * m2``;
  * cross-attention to the context: ``norm3`` (LayerNorm with affine) -> q,
    RMS-normed q and k, ``x += o(.)`` with no gate (span ``dit.cross_attn``);
  * MLP: ``x += ffn(LN(x)(1 + m4) + m3) * m5``, GELU-tanh;

and the head (shift, scale) = ``head.modulation`` + e, a linear to the
patch's 64 values, unpatchified to [B, 16, F, H, W].

Precision, as Wan's own forward under bf16 autocast: LayerNorms, the
modulation, the residual stream and the head in fp32; the q, k RMS norms in
fp32 rounded to the model dtype before their gains; the other matmuls in the
model dtype. The q and k RMS norms span all heads, so one head's logit can
reach |q| |k| / sqrt(D) = dim / sqrt(D) (453 at the 14B): attention takes the
online softmax (``bounded_logits=False``), through ops/attention.py (K1 at
head dim 128 on the card). Every attention call counts ``dit.attn_n``, and
each that launched K1 ``dit.attn_kernel_n``.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from dove_tpu_torch import obs
from dove_tpu_torch.config import WanDiTConfig
from dove_tpu_torch.ops import flash_attention as fa
from dove_tpu_torch.ops.attention import full_attention
from dove_tpu_torch.ops.rope import apply_rotary, wan_rope_3d


def _ln(x: torch.Tensor, eps: float) -> torch.Tensor:
    """LayerNorm without affine over the last axis, fp32."""
    return F.layer_norm(x.float(), x.shape[-1:], eps=eps)


class WanRMSNorm(nn.Module):
    """RMS over the last axis in fp32, rounded to x's dtype, times the gain."""

    def __init__(self, dim: int, eps: float, device=None, dtype=None):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim, device=device, dtype=dtype))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        y = xf * torch.rsqrt(xf.pow(2).mean(dim=-1, keepdim=True) + self.eps)
        return y.to(x.dtype) * self.weight


class WanLayerNorm(nn.Module):
    """``norm3``: LayerNorm with affine, in fp32."""

    def __init__(self, dim: int, eps: float, device=None, dtype=None):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim, device=device, dtype=dtype))
        self.bias = nn.Parameter(torch.zeros(dim, device=device, dtype=dtype))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.layer_norm(x.float(), x.shape[-1:], self.weight.float(),
                            self.bias.float(), self.eps)


def _attend(q, k, v, backend: str | None) -> torch.Tensor:
    """[B, H, Sq, D] attention, online softmax; counts the call and, where it
    launched K1, the launch."""
    before = fa.launches.count
    out = full_attention(q, k, v, backend=backend, bounded_logits=False)
    obs.count("dit.attn_n", 1)
    obs.count("dit.attn_kernel_n", fa.launches.count - before)
    return out


class _Attention(nn.Module):
    """Wan's self- and cross-attention weights: q, k, v, o with bias, and
    the RMS norms of q and k over all channels."""

    def __init__(self, cfg: WanDiTConfig, **kw):
        super().__init__()
        dim = cfg.dim
        self.heads, self.head_dim = cfg.num_heads, cfg.head_dim
        self.q = nn.Linear(dim, dim, **kw)
        self.k = nn.Linear(dim, dim, **kw)
        self.v = nn.Linear(dim, dim, **kw)
        self.o = nn.Linear(dim, dim, **kw)
        self.norm_q = WanRMSNorm(dim, cfg.eps, **kw)
        self.norm_k = WanRMSNorm(dim, cfg.eps, **kw)

    def heads_of(self, t: torch.Tensor) -> torch.Tensor:
        """[B, S, dim] -> [B, H, S, D]."""
        B, S, _ = t.shape
        return t.view(B, S, self.heads, self.head_dim).transpose(1, 2)

    def out(self, o: torch.Tensor) -> torch.Tensor:
        """[B, H, S, D] -> o([B, S, dim])."""
        B, _, S, _ = o.shape
        return self.o(o.transpose(1, 2).reshape(B, S, -1))

    def self_attention(self, h, rope, backend) -> torch.Tensor:
        cos, sin = rope
        q = apply_rotary(self.heads_of(self.norm_q(self.q(h))), cos, sin).contiguous()
        k = apply_rotary(self.heads_of(self.norm_k(self.k(h))), cos, sin).contiguous()
        v = self.heads_of(self.v(h)).contiguous()
        return self.out(_attend(q, k, v, backend))

    def cross_attention(self, h, context, backend) -> torch.Tensor:
        q = self.heads_of(self.norm_q(self.q(h))).contiguous()
        k = self.heads_of(self.norm_k(self.k(context))).contiguous()
        v = self.heads_of(self.v(context)).contiguous()
        return self.out(_attend(q, k, v, backend))


class WanAttentionBlock(nn.Module):
    def __init__(self, cfg: WanDiTConfig, **kw):
        super().__init__()
        self.eps = cfg.eps
        self.self_attn = _Attention(cfg, **kw)
        self.norm3 = WanLayerNorm(cfg.dim, cfg.eps, **kw)
        self.cross_attn = _Attention(cfg, **kw)
        self.ffn = nn.Sequential(nn.Linear(cfg.dim, cfg.ffn_dim, **kw),
                                 nn.GELU(approximate="tanh"),
                                 nn.Linear(cfg.ffn_dim, cfg.dim, **kw))
        self.modulation = nn.Parameter(torch.empty(1, 6, cfg.dim, **kw))

    def forward(self, x, e0, context, rope, backend):
        """x: [B, S, dim] fp32; e0: [B, 6, dim] fp32; context [B, L, dim] in
        the model dtype."""
        dt = context.dtype
        m = (self.modulation.float() + e0).unbind(1)
        h = (_ln(x, self.eps) * (1 + m[1][:, None]) + m[0][:, None]).to(dt)
        x = x + self.self_attn.self_attention(h, rope, backend).float() * m[2][:, None]
        with obs.span("dit.cross_attn"):
            h = self.norm3(x).to(dt)
            x = x + self.cross_attn.cross_attention(h, context, backend).float()
        h = (_ln(x, self.eps) * (1 + m[4][:, None]) + m[3][:, None]).to(dt)
        return x + self.ffn(h).float() * m[5][:, None]


class _Head(nn.Module):
    def __init__(self, cfg: WanDiTConfig, **kw):
        super().__init__()
        self.eps = cfg.eps
        self.head = nn.Linear(cfg.dim, math.prod(cfg.patch_size) * cfg.out_dim, **kw)
        self.modulation = nn.Parameter(torch.empty(1, 2, cfg.dim, **kw))

    def forward(self, x: torch.Tensor, e: torch.Tensor) -> torch.Tensor:
        shift, scale = (self.modulation.float() + e[:, None]).unbind(1)
        h = _ln(x, self.eps) * (1 + scale[:, None]) + shift[:, None]
        return F.linear(h, self.head.weight.float(), self.head.bias.float())


def sinusoidal_embedding(dim: int, t: torch.Tensor) -> torch.Tensor:
    """[cos | sin] of t * 10000^(-k / (dim / 2)), k < dim / 2, computed in
    float64 as Wan does -> fp32 [B, dim]."""
    half = dim // 2
    pos = t.to(torch.float64)
    freq = torch.pow(10000.0, -torch.arange(half, dtype=torch.float64,
                                            device=t.device) / half)
    angle = torch.outer(pos, freq)
    return torch.cat([torch.cos(angle), torch.sin(angle)], dim=1).float()


class WanModel(nn.Module):
    """The Wan2.1 T2V DiT; ``forward`` is one velocity prediction."""

    def __init__(self, cfg: WanDiTConfig, device=None, dtype=None):
        super().__init__()
        if not (cfg.qk_norm and cfg.cross_attn_norm) or tuple(cfg.window_size) != (-1, -1):
            raise ValueError("the port runs Wan2.1's T2V block: qk_norm, cross_attn_norm "
                             "and full attention (window (-1, -1))")
        kw = {"device": device, "dtype": dtype}
        self.cfg = cfg
        self.patch_embedding = nn.Conv3d(cfg.in_dim, cfg.dim, kernel_size=cfg.patch_size,
                                         stride=cfg.patch_size, **kw)
        self.text_embedding = nn.Sequential(nn.Linear(cfg.text_dim, cfg.dim, **kw),
                                            nn.GELU(approximate="tanh"),
                                            nn.Linear(cfg.dim, cfg.dim, **kw))
        self.time_embedding = nn.Sequential(nn.Linear(cfg.freq_dim, cfg.dim, **kw),
                                            nn.SiLU(), nn.Linear(cfg.dim, cfg.dim, **kw))
        self.time_projection = nn.Sequential(nn.SiLU(),
                                             nn.Linear(cfg.dim, 6 * cfg.dim, **kw))
        self.blocks = nn.ModuleList([WanAttentionBlock(cfg, **kw)
                                     for _ in range(cfg.num_layers)])
        self.head = _Head(cfg, **kw)

    def context(self, text: torch.Tensor) -> torch.Tensor:
        """[B, L <= text_len, text_dim] -> the embedded context [B, text_len,
        dim]: the prompt's rows, then zero rows up to ``text_len``."""
        B, L, _ = text.shape
        if L > self.cfg.text_len:
            raise ValueError(f"a prompt embedding of {L} rows exceeds {self.cfg.text_len}")
        w = self.text_embedding[0].weight
        text = F.pad(text.to(w.dtype), (0, 0, 0, self.cfg.text_len - L))
        return self.text_embedding(text)

    def forward(self, latent: torch.Tensor, text: torch.Tensor, timestep: torch.Tensor,
                *, attention_backend: str | None = None) -> torch.Tensor:
        """latent [B, in_dim, F, H, W]; text [B, L, text_dim]; timestep [B]
        -> the velocity u [B, out_dim, F, H, W] fp32."""
        cfg = self.cfg
        pt, ph, pw = cfg.patch_size
        B, _, Fr, H, W = latent.shape
        grid = (Fr // pt, H // ph, W // pw)
        dt = self.patch_embedding.weight.dtype
        x = self.patch_embedding(latent.to(dt)).flatten(2).transpose(1, 2).float()

        te = self.time_embedding
        e = F.linear(sinusoidal_embedding(cfg.freq_dim, timestep),
                     te[0].weight.float(), te[0].bias.float())
        e = F.linear(F.silu(e), te[2].weight.float(), te[2].bias.float())
        tp = self.time_projection[1]
        e0 = F.linear(F.silu(e), tp.weight.float(), tp.bias.float()).unflatten(1, (6, cfg.dim))

        context = self.context(text)
        rope = wan_rope_3d(cfg.head_dim, *grid, cfg.rope_theta, device=latent.device)
        for block in self.blocks:
            x = block(x, e0, context, rope, attention_backend)
        u = self.head(x, e)
        u = u.view(B, *grid, pt, ph, pw, cfg.out_dim)
        u = torch.einsum("bfhwpqrc->bcfphqwr", u)
        return u.reshape(B, cfg.out_dim, Fr, H, W)


@torch.no_grad()
def init_wan_params(model: nn.Module, seed: int = 0) -> nn.Module:
    """Seeded weights for tests: N(0, 1 / fan_in) for every tensor of more
    than one axis (the modulations and the VAE's gains included), gains
    one, biases zero."""
    gen = np.random.default_rng(seed)
    for name, p in model.state_dict().items():
        if name.endswith(".bias"):
            p.zero_()
        elif p.ndim == 1:
            p.fill_(1.0)
        else:
            fan_in = math.prod(p.shape[1:])
            vals = gen.standard_normal(p.shape).astype(np.float32) / math.sqrt(fan_in)
            p.copy_(torch.from_numpy(vals))
    return model
