"""CogVideoX Transformer3D ("DiT"), 1.5-5B structure, as a PyTorch module.

Counterpart of ``dove_tpu/models/dit.py`` (``dit_forward``). Module and
parameter names follow the diffusers checkpoint (``transformer_blocks.{i}.
attn1.to_q.weight``, ...), so a released state dict loads with
``load_state_dict`` and ``nn.Linear`` keeps torch's [out, in] layout.

Architecture: 3D patchify (p=2, p_t=2) as one linear, T5 text projection,
joint [text|video] token sequence, blocks of adaLN-zero -> qk-layernorm full
attention with 3D RoPE on the video segment -> adaLN-zero -> GELU-tanh MLP,
then the joint final norm, the (shift, scale) adaLN and the linear
unpatchify. LayerNorms and adaLN math run in fp32, matmuls in the model
dtype. Attention goes through ops/attention.py, which takes the K1 kernel on
the card for long sequences.

Not ported yet: the 2B variant (conv2d patchify + sincos positions), tensor
and sequence parallelism, remat and the int8 linears.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from dove_tpu_torch.config import DiTConfig
from dove_tpu_torch.ops.attention import full_attention
from dove_tpu_torch.ops.rope import apply_rotary, rope_3d


def _layer_norm(
    x: torch.Tensor, eps: float, weight: torch.Tensor | None = None,
    bias: torch.Tensor | None = None,
) -> torch.Tensor:
    """LayerNorm over the last axis in fp32, cast back to x's dtype."""
    y = F.layer_norm(x.float(), x.shape[-1:], eps=eps)
    if weight is not None:
        y = y * weight.float() + bias.float()
    return y.to(x.dtype)


class LayerNorm(nn.Module):
    """Affine LayerNorm with the fp32 math of ``_layer_norm``."""

    def __init__(self, dim: int, eps: float, device=None, dtype=None):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim, device=device, dtype=dtype))
        self.bias = nn.Parameter(torch.zeros(dim, device=device, dtype=dtype))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return _layer_norm(x, self.eps, self.weight, self.bias)


def _timestep_embedding(
    t: torch.Tensor, dim: int, flip_sin_to_cos: bool, freq_shift: float
) -> torch.Tensor:
    """Sinusoidal timestep features, shape [B, dim], fp32."""
    half = dim // 2
    exponent = (
        -math.log(10000.0)
        * torch.arange(half, dtype=torch.float32, device=t.device)
        / (half - freq_shift)
    )
    emb = t.float()[:, None] * torch.exp(exponent)[None, :]
    sin, cos = torch.sin(emb), torch.cos(emb)
    return torch.cat([cos, sin] if flip_sin_to_cos else [sin, cos], dim=-1)


class _AdaNorm(nn.Module):
    """adaLN: linear(silu(temb)) chunks plus the LayerNorm they modulate."""

    def __init__(self, cfg: DiTConfig, n_chunks: int, **kw):
        super().__init__()
        self.n_chunks = n_chunks
        self.linear = nn.Linear(cfg.time_embed_dim, n_chunks * cfg.hidden_dim, **kw)
        self.norm = LayerNorm(cfg.hidden_dim, cfg.norm_eps, **kw)

    def modulation(self, temb: torch.Tensor) -> list[torch.Tensor]:
        """n_chunks tensors of [B, 1, dim]."""
        h = self.linear(F.silu(temb))
        return [c[:, None, :] for c in h.chunk(self.n_chunks, dim=-1)]


class _Attention(nn.Module):
    def __init__(self, cfg: DiTConfig, **kw):
        super().__init__()
        dim, bias = cfg.hidden_dim, cfg.attention_bias
        self.heads = cfg.num_attention_heads
        self.head_dim = cfg.attention_head_dim
        self.to_q = nn.Linear(dim, dim, bias=bias, **kw)
        self.to_k = nn.Linear(dim, dim, bias=bias, **kw)
        self.to_v = nn.Linear(dim, dim, bias=bias, **kw)
        self.to_out = nn.ModuleList([nn.Linear(dim, dim, bias=True, **kw)])
        self.norm_q = LayerNorm(self.head_dim, cfg.qk_norm_eps, **kw)
        self.norm_k = LayerNorm(self.head_dim, cfg.qk_norm_eps, **kw)

    def forward(
        self,
        hidden: torch.Tensor,
        encoder: torch.Tensor,
        rope: tuple[torch.Tensor, torch.Tensor] | None,
        backend: str | None,
        bounded_logits: bool,
    ) -> tuple[torch.Tensor, torch.Tensor]:
        """Joint attention over [text | video]; returns (video_out, text_out)."""
        text_len = encoder.shape[1]
        x = torch.cat([encoder, hidden], dim=1)
        B, S, _ = x.shape
        H, D = self.heads, self.head_dim

        def heads(t: torch.Tensor) -> torch.Tensor:
            return t.view(B, S, H, D).transpose(1, 2)  # [B, H, S, D]

        q = self.norm_q(heads(self.to_q(x)))
        k = self.norm_k(heads(self.to_k(x)))
        v = heads(self.to_v(x)).contiguous()
        if rope is not None:
            cos, sin = rope
            q = torch.cat(
                [q[:, :, :text_len], apply_rotary(q[:, :, text_len:], cos, sin)], dim=2
            )
            k = torch.cat(
                [k[:, :, :text_len], apply_rotary(k[:, :, text_len:], cos, sin)], dim=2
            )
        # qk-layernorm bounds the per-head logits only while the gains stay
        # near their pretrained magnitude: bounded_logits is for inference.
        o = full_attention(q, k, v, backend=backend, bounded_logits=bounded_logits)
        o = o.transpose(1, 2).reshape(B, S, H * D)
        out = self.to_out[0](o)
        return out[:, text_len:], out[:, :text_len]


class _GeluProj(nn.Module):
    def __init__(self, d_in: int, d_out: int, **kw):
        super().__init__()
        self.proj = nn.Linear(d_in, d_out, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.gelu(self.proj(x), approximate="tanh")


class _FeedForward(nn.Module):
    def __init__(self, cfg: DiTConfig, **kw):
        super().__init__()
        # diffusers' FeedForward.net = [GELU(proj), Dropout, Linear]
        self.net = nn.ModuleList([
            _GeluProj(cfg.hidden_dim, cfg.ff_dim, **kw),
            nn.Identity(),
            nn.Linear(cfg.ff_dim, cfg.hidden_dim, **kw),
        ])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.net[2](self.net[0](x))


class _Block(nn.Module):
    def __init__(self, cfg: DiTConfig, **kw):
        super().__init__()
        self.norm1 = _AdaNorm(cfg, 6, **kw)
        self.attn1 = _Attention(cfg, **kw)
        self.norm2 = _AdaNorm(cfg, 6, **kw)
        self.ff = _FeedForward(cfg, **kw)

    def forward(self, hidden, encoder, temb, rope, backend, bounded_logits):
        # adaLN-zero #1 -> attention
        shift, scale, gate, e_shift, e_scale, e_gate = self.norm1.modulation(temb)
        n_hidden = self.norm1.norm(hidden) * (1 + scale) + shift
        n_encoder = self.norm1.norm(encoder) * (1 + e_scale) + e_shift
        attn_h, attn_e = self.attn1(
            n_hidden, n_encoder, rope, backend, bounded_logits
        )
        hidden = hidden + gate * attn_h
        encoder = encoder + e_gate * attn_e

        # adaLN-zero #2 -> feed-forward over the joint sequence
        shift, scale, gate, e_shift, e_scale, e_gate = self.norm2.modulation(temb)
        n_hidden = self.norm2.norm(hidden) * (1 + scale) + shift
        n_encoder = self.norm2.norm(encoder) * (1 + e_scale) + e_shift
        ff = self.ff(torch.cat([n_encoder, n_hidden], dim=1))
        text_len = encoder.shape[1]
        hidden = hidden + gate * ff[:, text_len:]
        encoder = encoder + e_gate * ff[:, :text_len]
        return hidden, encoder


class _PatchEmbed(nn.Module):
    def __init__(self, cfg: DiTConfig, **kw):
        super().__init__()
        patch_dim = cfg.in_channels * cfg.patch_size_t * cfg.patch_size**2
        self.proj = nn.Linear(patch_dim, cfg.hidden_dim, bias=cfg.patch_bias, **kw)
        self.text_proj = nn.Linear(cfg.text_embed_dim, cfg.hidden_dim, **kw)


class _TimeEmbedding(nn.Module):
    def __init__(self, cfg: DiTConfig, **kw):
        super().__init__()
        self.linear_1 = nn.Linear(cfg.hidden_dim, cfg.time_embed_dim, **kw)
        self.linear_2 = nn.Linear(cfg.time_embed_dim, cfg.time_embed_dim, **kw)


class _NormOut(nn.Module):
    def __init__(self, cfg: DiTConfig, **kw):
        super().__init__()
        self.linear = nn.Linear(cfg.time_embed_dim, 2 * cfg.hidden_dim, **kw)
        self.norm = LayerNorm(cfg.hidden_dim, cfg.norm_eps, **kw)


def patchify(cfg: DiTConfig, latent: torch.Tensor) -> torch.Tensor:
    """latent [B, F, C, H, W] -> patches [B, S_vid, C*pt*p*p].

    Token order: F-major, then H, then W. Feature order within a patch:
    (C, p_t, p_h, p_w) with C slowest, as the released checkpoints expect."""
    B, Fr, C, H, W = latent.shape
    p, pt = cfg.patch_size, cfg.patch_size_t
    x = latent.reshape(B, Fr // pt, pt, C, H // p, p, W // p, p)
    x = x.permute(0, 1, 4, 6, 3, 2, 5, 7)
    return x.reshape(B, (Fr // pt) * (H // p) * (W // p), C * pt * p * p)


def unpatchify(
    cfg: DiTConfig, tokens: torch.Tensor, frames: int, height: int, width: int
) -> torch.Tensor:
    """video tokens [B, S_vid, C*pt*p*p] -> latent [B, F, C_out, H, W]."""
    p, pt = cfg.patch_size, cfg.patch_size_t
    B = tokens.shape[0]
    f, h, w = frames // pt, height // p, width // p
    x = tokens.reshape(B, f, h, w, -1, pt, p, p)
    x = x.permute(0, 1, 5, 4, 2, 6, 3, 7)
    return x.reshape(B, frames, -1, height, width)


class CogVideoXTransformer3D(nn.Module):
    """The DiT. ``forward`` is ``dove_tpu.models.dit.dit_forward``."""

    def __init__(self, cfg: DiTConfig, device=None, dtype=None):
        super().__init__()
        if cfg.patch_size_t is None or not cfg.use_rotary_positional_embeddings:
            raise NotImplementedError(
                "the CogVideoX-2B structure (conv2d patchify, sincos "
                "positions) is not ported yet"
            )
        kw = {"device": device, "dtype": dtype}
        self.cfg = cfg
        self.patch_embed = _PatchEmbed(cfg, **kw)
        self.time_embedding = _TimeEmbedding(cfg, **kw)
        self.transformer_blocks = nn.ModuleList(
            [_Block(cfg, **kw) for _ in range(cfg.num_layers)]
        )
        self.norm_final = LayerNorm(cfg.hidden_dim, cfg.norm_eps, **kw)
        self.norm_out = _NormOut(cfg, **kw)
        out_dim = cfg.out_channels * cfg.patch_size_t * cfg.patch_size**2
        self.proj_out = nn.Linear(cfg.hidden_dim, out_dim, **kw)

    def forward(
        self,
        latent: torch.Tensor,
        text_embeds: torch.Tensor,
        timestep: torch.Tensor,
        *,
        attention_backend: str | None = None,
        bounded_logits: bool = False,
    ) -> torch.Tensor:
        """One DiT pass.

        latent: [B, F, C, H, W] noisy latent, F divisible by patch_size_t;
        text_embeds: [B, L_text, text_embed_dim] T5 features; timestep: [B]
        integer timesteps. bounded_logits is the inference-only flash path
        (safe only with frozen, near-unit qk-layernorm gains). Returns the
        velocity prediction [B, F, C_out, H, W]."""
        cfg = self.cfg
        B, Fr, _, Hh, Ww = latent.shape
        dtype = latent.dtype

        t_feat = _timestep_embedding(
            timestep, cfg.hidden_dim, cfg.flip_sin_to_cos, cfg.freq_shift
        ).to(dtype)
        te = self.time_embedding
        temb = te.linear_2(F.silu(te.linear_1(t_feat)))

        hidden = self.patch_embed.proj(patchify(cfg, latent))
        encoder = self.patch_embed.text_proj(text_embeds.to(dtype))

        rope = rope_3d(
            cfg.attention_head_dim,
            Fr // cfg.patch_size_t,
            Hh // cfg.patch_size,
            Ww // cfg.patch_size,
            cfg.rope_theta,
            device=latent.device,
        )
        for block in self.transformer_blocks:
            hidden, encoder = block(
                hidden, encoder, temb, rope, attention_backend, bounded_logits
            )

        # Final norm over the joint sequence, adaLN (shift, scale), projection
        text_len = encoder.shape[1]
        hidden = self.norm_final(torch.cat([encoder, hidden], dim=1))[:, text_len:]
        shift, scale = self.norm_out.linear(F.silu(temb)).chunk(2, dim=-1)
        hidden = self.norm_out.norm(hidden) * (1 + scale[:, None]) + shift[:, None]
        hidden = self.proj_out(hidden)
        return unpatchify(cfg, hidden, Fr, Hh, Ww)


@torch.no_grad()
def init_dit_params(
    cfg: DiTConfig, seed: int = 0, device="cpu", dtype=torch.float32
) -> CogVideoXTransformer3D:
    """A DiT with seeded random weights, the distribution of the JAX
    package's ``init_dit_params``: linear weights uniform in +-1/sqrt(d_in),
    biases 0, LayerNorm gains 1 and biases 0. Built on ``device`` directly."""
    with torch.device("meta"):
        model = CogVideoXTransformer3D(cfg, dtype=dtype)
    model = model.to_empty(device=device)
    gen = torch.Generator(device=device).manual_seed(seed)
    for mod in model.modules():
        if isinstance(mod, nn.Linear):
            bound = 1.0 / math.sqrt(mod.in_features)
            mod.weight.uniform_(-bound, bound, generator=gen)
            if mod.bias is not None:
                mod.bias.zero_()
        elif isinstance(mod, LayerNorm):
            mod.weight.fill_(1.0)
            mod.bias.zero_()
    return model.eval().requires_grad_(False)
