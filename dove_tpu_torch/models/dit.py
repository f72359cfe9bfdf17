"""CogVideoX Transformer3D ("DiT"), 1.5-5B and 2B structures, as a PyTorch module.

Counterpart of ``dove_tpu/models/dit.py`` (``dit_forward``). Module and
parameter names follow the diffusers checkpoint (``transformer_blocks.{i}.
attn1.to_q.weight``, ...), so a released state dict loads with
``load_state_dict`` and ``nn.Linear`` keeps torch's [out, in] layout.

Architecture (1.5-5B): 3D patchify (p=2, p_t=2) as one linear, T5 text
projection, joint [text|video] token sequence, blocks of adaLN-zero ->
qk-layernorm full attention with 3D RoPE on the video segment -> adaLN-zero
-> GELU-tanh MLP, then the joint final norm, the (shift, scale) adaLN and
the linear unpatchify. The 2B family (``patch_size_t=None``, no RoPE)
patchifies each frame with a stride-p conv2d and adds fixed 3D sincos
positions instead: the stored ``pos_embedding`` table (text part zeros) to
the joint sequence at the config's sample grid, a table recomputed for the
actual grid to the video tokens at any other; its final norm sees the video
tokens alone. LayerNorms and adaLN math run in fp32, matmuls in the model
dtype. Attention goes through ops/attention.py, which takes the K1 kernel on
the card for long sequences (with gradients: K1 with the logsumexp, and K3a
and K3b behind it).

Training: ``forward(..., lora=..., gradient_checkpointing=True)``. A LoRA
tree (train/lora.py) is merged into the attention projections inside each
block, so a checkpointed block recomputes the merge instead of holding 42
merged copies; per-block ``torch.utils.checkpoint`` is the counterpart of the
JAX package's ``jax.checkpoint(_block, policy=nothing_saveable)``.

Tensor and sequence parallelism (``parallel/tp.py``): a DiT split by
``shard_dit_tp`` holds its ranks' heads and MLP channels (``self.tp``); the
row-parallel linears sum over the "model" group and add their bias once, the
head count follows the local q width, and LoRA factors act on the slice of
the weight the rank holds. ``forward(sp=...)`` token-shards the attention
core and the MLP over a further group. The int8 linears are ops/quant.py's.
"""

from __future__ import annotations

import math
from collections import OrderedDict
from typing import Mapping

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from dove_tpu_torch.config import DiTConfig
from dove_tpu_torch.ops.attention import full_attention
from dove_tpu_torch.ops.rope import apply_rotary, rope_3d
from dove_tpu_torch.ops.sincos import get_3d_sincos_pos_embed
from dove_tpu_torch.parallel.tp import Group, copy_to, reduce_from, token_shard
from dove_tpu_torch.train.lora import LoraLayer, lora_layer, merged_weight


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

    def forward(self, x: torch.Tensor, tp: Group | None = None) -> torch.Tensor:
        """``tp``: the gains act on this rank's heads only (the per-head
        qk-norms under TP), so their gradients sum over the group."""
        return _layer_norm(x, self.eps, copy_to(self.weight, tp), copy_to(self.bias, tp))


def _apply_linear(lin: nn.Module, x: torch.Tensor, weight: torch.Tensor | None = None,
                  row_tp: Group | None = None, sp: Group | None = None) -> torch.Tensor:
    """``lin`` on ``x``, ``weight`` in place of its float weight (a LoRA
    merge). ``row_tp``: a row-parallel layer, whose partial products sum
    over the group before the bias is added once. ``sp``: inside a
    token-sharded function, where each rank sees its tokens only, so the
    weights' gradients sum over the sequence group."""
    if not isinstance(lin, nn.Linear):  # int8 (ops/quant.py): inference only
        if row_tp is None:
            return lin(x)
        y = reduce_from(lin.matmul(x), row_tp)
        return y if lin.bias is None else y + lin.bias.to(y.dtype)
    w = copy_to(lin.weight if weight is None else weight, sp)
    b = copy_to(lin.bias, sp)
    if row_tp is None:
        return F.linear(x, w, b)
    y = reduce_from(F.linear(x, w), row_tp)
    return y if b is None else y + b


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

    def _project(self, target: str, x: torch.Tensor, lora: LoraLayer | None,
                 tp: Group | None = None, sp: Group | None = None):
        """One of the LoRA targets ("to_q", "to_k", "to_v", "to_out"), with
        the adapter merged into its weight when the layer has one. Under TP
        the weight is this rank's slice (rows of the column-parallel q, k,
        v; columns of ``to_out``, which then sums over the group) and so is
        the adapter's product; the factors stay whole on every rank, each
        rank's gradient of them is its slice's part, summed over the group."""
        row = target == "to_out"
        lin = self.to_out[0] if row else getattr(self, target)
        row_tp = tp if row else None
        if lora is None or target not in lora.ab:
            return _apply_linear(lin, x, row_tp=row_tp, sp=sp)
        if not isinstance(lin, nn.Linear):
            raise NotImplementedError("LoRA on a quantized DiT is not ported")
        a, b = lora.ab[target]
        if tp is not None:
            a, b = copy_to(a, tp), copy_to(b, tp)
            if row:
                n = lin.weight.shape[1]
                a = a.narrow(0, tp.rank * n, n)
            else:
                n = lin.weight.shape[0]
                b = b.narrow(1, tp.rank * n, n)
        w = merged_weight(lin.weight, a, b, lora.scale)
        return _apply_linear(lin, x, w, row_tp=row_tp, sp=sp)

    def forward(
        self,
        hidden: torch.Tensor,
        encoder: torch.Tensor,
        rope: tuple[torch.Tensor, torch.Tensor] | None,
        backend: str | None,
        bounded_logits: bool,
        lora: LoraLayer | None = None,
        tp: Group | None = None,
        sp: Group | None = None,
    ) -> tuple[torch.Tensor, torch.Tensor]:
        """Joint attention over [text | video]; returns (video_out, text_out).
        Under TP the q, k, v projections hold this rank's heads: the head
        count follows their width."""
        text_len = encoder.shape[1]
        x = copy_to(torch.cat([encoder, hidden], dim=1), tp)
        B, S, _ = x.shape
        D = self.head_dim

        def heads(t: torch.Tensor) -> torch.Tensor:
            return t.view(B, S, -1, D).transpose(1, 2)  # [B, H, S, D]

        q = self.norm_q(heads(self._project("to_q", x, lora, tp)), tp)
        k = self.norm_k(heads(self._project("to_k", x, lora, tp)), tp)
        v = heads(self._project("to_v", x, lora, tp)).contiguous()
        if rope is not None:
            cos, sin = rope
            q = torch.cat(
                [q[:, :, :text_len], apply_rotary(q[:, :, text_len:], cos, sin)], dim=2
            )
            k = torch.cat(
                [k[:, :, :text_len], apply_rotary(k[:, :, text_len:], cos, sin)], dim=2
            )
        if sp is not None:
            q, k, v = copy_to(q, sp), copy_to(k, sp), copy_to(v, sp)

        # qk-layernorm bounds the per-head logits only while the gains stay
        # near their pretrained magnitude: inference takes the bounded form,
        # training the online form with the logsumexp that K3 reads.
        def core(qc: torch.Tensor) -> torch.Tensor:
            # attention + out-projection for a [B, H, Sq, D] query slice
            # (K and V stay whole: the kernels take Sq != Skv)
            o = full_attention(qc, k, v, backend=backend, bounded_logits=bounded_logits)
            o = o.transpose(1, 2).reshape(B, qc.shape[2], -1)
            return self._project("to_out", o, lora, tp, sp)

        out = core(q) if sp is None else token_shard(core, q, sp, 2, 1)
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

    def forward(self, x: torch.Tensor, tp: Group | None = None,
                sp: Group | None = None) -> torch.Tensor:
        def core(xc: torch.Tensor) -> torch.Tensor:
            h = F.gelu(_apply_linear(self.net[0].proj, xc, sp=sp), approximate="tanh")
            return _apply_linear(self.net[2], h, row_tp=tp, sp=sp)

        x = copy_to(x, tp)
        return core(x) if sp is None else token_shard(core, copy_to(x, sp), sp, 1, 1)


class _Block(nn.Module):
    def __init__(self, cfg: DiTConfig, **kw):
        super().__init__()
        self.norm1 = _AdaNorm(cfg, 6, **kw)
        self.attn1 = _Attention(cfg, **kw)
        self.norm2 = _AdaNorm(cfg, 6, **kw)
        self.ff = _FeedForward(cfg, **kw)

    def forward(self, hidden, encoder, temb, rope, backend, bounded_logits,
                lora: LoraLayer | None = None, tp: Group | None = None,
                sp: Group | None = None):
        # adaLN-zero #1 -> attention
        shift, scale, gate, e_shift, e_scale, e_gate = self.norm1.modulation(temb)
        n_hidden = self.norm1.norm(hidden) * (1 + scale) + shift
        n_encoder = self.norm1.norm(encoder) * (1 + e_scale) + e_shift
        attn_h, attn_e = self.attn1(
            n_hidden, n_encoder, rope, backend, bounded_logits, lora, tp, sp
        )
        hidden = hidden + gate * attn_h
        encoder = encoder + e_gate * attn_e

        # adaLN-zero #2 -> feed-forward over the joint sequence
        shift, scale, gate, e_shift, e_scale, e_gate = self.norm2.modulation(temb)
        n_hidden = self.norm2.norm(hidden) * (1 + scale) + shift
        n_encoder = self.norm2.norm(encoder) * (1 + e_scale) + e_shift
        ff = self.ff(torch.cat([n_encoder, n_hidden], dim=1), tp, sp)
        text_len = encoder.shape[1]
        hidden = hidden + gate * ff[:, text_len:]
        encoder = encoder + e_gate * ff[:, :text_len]
        return hidden, encoder


def sample_grid(cfg: DiTConfig) -> tuple[int, int, int]:
    """The (frames, height, width) token grid of the config's sample size:
    the grid the stored sincos table is valid for."""
    return ((cfg.sample_frames - 1) // cfg.temporal_compression_ratio + 1,
            cfg.sample_height // cfg.patch_size, cfg.sample_width // cfg.patch_size)


def sincos_table(cfg: DiTConfig, grid: tuple[int, int, int]) -> np.ndarray:
    """The fixed 3D sincos positions of a (frames, height, width) token grid,
    float64 [T * H * W, dim], token order as patchify's."""
    t, h, w = grid
    return get_3d_sincos_pos_embed(
        cfg.hidden_dim, w, h, t, cfg.spatial_interpolation_scale,
        cfg.temporal_interpolation_scale).reshape(-1, cfg.hidden_dim)


def stored_pos_embedding(cfg: DiTConfig) -> torch.Tensor:
    """The 2B's ``pos_embedding`` buffer as diffusers builds it: zeros for
    the ``max_text_seq_length`` text slots, then the sample grid's sincos
    table; fp32 [1, L_text + T * H * W, dim]."""
    pos = sincos_table(cfg, sample_grid(cfg))
    text = np.zeros((cfg.max_text_seq_length, cfg.hidden_dim))
    return torch.from_numpy(np.concatenate([text, pos])[None]).float()


def temporal_pad(cfg: DiTConfig, frames: int) -> int:
    """Latent frames to prepend so that ``frames`` fills whole temporal
    patches: (pt - F % pt) % pt, 0 without temporal patching (the 2B)."""
    pt = cfg.patch_size_t
    return 0 if pt is None else (pt - frames % pt) % pt


class _PatchEmbed(nn.Module):
    def __init__(self, cfg: DiTConfig, **kw):
        super().__init__()
        p = cfg.patch_size
        if cfg.patch_size_t is None:
            # CogVideoX-1.0: a stride-p conv2d over each frame
            self.proj = nn.Conv2d(cfg.in_channels, cfg.hidden_dim, p, stride=p,
                                  bias=True, **kw)
        else:
            patch_dim = cfg.in_channels * cfg.patch_size_t * p**2
            self.proj = nn.Linear(patch_dim, cfg.hidden_dim, bias=cfg.patch_bias, **kw)
        self.text_proj = nn.Linear(cfg.text_embed_dim, cfg.hidden_dim, **kw)
        if not cfg.use_rotary_positional_embeddings:
            t, h, w = sample_grid(cfg)
            self.register_buffer("pos_embedding", torch.empty(
                (1, cfg.max_text_seq_length + t * h * w, cfg.hidden_dim), **kw))

    def embed(self, cfg: DiTConfig, latent: torch.Tensor) -> torch.Tensor:
        """latent [B, F, C, H, W] -> video tokens [B, S_vid, dim]."""
        if cfg.patch_size_t is not None:
            return self.proj(patchify(cfg, latent))
        B, Fr, C, H, W = latent.shape
        x = self.proj(latent.reshape(B * Fr, C, H, W).to(self.proj.weight.dtype))
        return x.reshape(B, Fr, x.shape[1], -1).permute(0, 1, 3, 2).reshape(
            B, -1, x.shape[1])


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
    p, pt = cfg.patch_size, cfg.patch_size_t or 1
    B = tokens.shape[0]
    f, h, w = frames // pt, height // p, width // p
    x = tokens.reshape(B, f, h, w, -1, pt, p, p)
    x = x.permute(0, 1, 5, 4, 2, 6, 3, 7)
    return x.reshape(B, frames, -1, height, width)


class CogVideoXTransformer3D(nn.Module):
    """The DiT. ``forward`` is ``dove_tpu.models.dit.dit_forward``."""

    def __init__(self, cfg: DiTConfig, device=None, dtype=None):
        super().__init__()
        kw = {"device": device, "dtype": dtype}
        self.cfg = cfg
        self.patch_embed = _PatchEmbed(cfg, **kw)
        self.time_embedding = _TimeEmbedding(cfg, **kw)
        self.transformer_blocks = nn.ModuleList(
            [_Block(cfg, **kw) for _ in range(cfg.num_layers)]
        )
        self.norm_final = LayerNorm(cfg.hidden_dim, cfg.norm_eps, **kw)
        self.norm_out = _NormOut(cfg, **kw)
        out_dim = cfg.out_channels * (cfg.patch_size_t or 1) * cfg.patch_size**2
        self.proj_out = nn.Linear(cfg.hidden_dim, out_dim, **kw)
        # the 2B's sincos tables of grids other than the sample grid, built
        # once per (grid, dtype, device), most recent last
        self._pos_cache: OrderedDict = OrderedDict()
        # the "model" group this DiT is split over (parallel/tp.py), or None
        self.tp: Group | None = None

    def _positions(self, grid: tuple[int, int, int], dtype: torch.dtype,
                   device: torch.device) -> torch.Tensor:
        """The sincos table of ``grid`` [1, T * H * W, dim] in ``dtype`` on
        ``device``: computed in float64 on the host and cast once, the JAX
        package's trace-time constant; kept for the next call."""
        key = (grid, dtype, device)
        table = self._pos_cache.pop(key, None)
        if table is None:
            table = torch.from_numpy(sincos_table(self.cfg, grid)[None]).to(dtype)
            table = table.to(device)
            while len(self._pos_cache) >= 4:
                self._pos_cache.popitem(last=False)
        self._pos_cache[key] = table
        return table

    def embed(
        self, latent: torch.Tensor, text_embeds: torch.Tensor, timestep: torch.Tensor,
    ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, tuple | None]:
        """The tokens the blocks take -> (hidden, encoder, temb, rope): the
        patch and text embeddings with the positions added (the 2B), the
        timestep embedding, and the RoPE tables (None for the 2B)."""
        cfg = self.cfg
        B, Fr, _, Hh, Ww = latent.shape
        dtype = latent.dtype
        t_feat = _timestep_embedding(
            timestep, cfg.hidden_dim, cfg.flip_sin_to_cos, cfg.freq_shift
        ).to(dtype)
        te = self.time_embedding
        temb = te.linear_2(F.silu(te.linear_1(t_feat)))

        hidden = self.patch_embed.embed(cfg, latent)
        encoder = self.patch_embed.text_proj(text_embeds.to(dtype))
        grid = (Fr // (cfg.patch_size_t or 1), Hh // cfg.patch_size, Ww // cfg.patch_size)
        if cfg.use_rotary_positional_embeddings:
            return hidden, encoder, temb, rope_3d(
                cfg.attention_head_dim, *grid, cfg.rope_theta, device=latent.device)
        if grid == sample_grid(cfg):
            # the stored table, valid only at the sample grid, over [text | video]
            joint = torch.cat([encoder, hidden], dim=1)
            joint = joint + self.patch_embed.pos_embedding[:, :joint.shape[1]].to(dtype)
            text_len = encoder.shape[1]
            return joint[:, text_len:], joint[:, :text_len], temb, None
        hidden = hidden + self._positions(grid, dtype, latent.device)
        return hidden, encoder, temb, None

    def forward(
        self,
        latent: torch.Tensor,
        text_embeds: torch.Tensor,
        timestep: torch.Tensor,
        *,
        attention_backend: str | None = None,
        bounded_logits: bool = False,
        lora: Mapping[str, Mapping[str, torch.Tensor]] | None = None,
        lora_scale: float = 1.0,
        gradient_checkpointing: bool = False,
        sp: Group | None = None,
    ) -> torch.Tensor:
        """One DiT pass.

        latent: [B, F, C, H, W] noisy latent, F divisible by patch_size_t
        (any F for the 2B);
        text_embeds: [B, L_text, text_embed_dim] T5 features; timestep: [B]
        integer timesteps. bounded_logits is the inference-only flash path
        (safe only with frozen, near-unit qk-layernorm gains). lora: a LoRA
        tree {target: {"A": [L, in, r], "B": [L, r, out]}} merged at
        ``lora_scale`` into each layer's attention projections.
        gradient_checkpointing recomputes each block in the backward pass
        (when gradients are on). sp: sequence parallelism over a group whose
        ranks all hold this whole batch (parallel/tp.py ``token_shard``).
        Returns the velocity prediction [B, F, C_out, H, W]."""
        cfg = self.cfg
        _, Fr, _, Hh, Ww = latent.shape
        hidden, encoder, temb, rope = self.embed(latent, text_embeds, timestep)
        remat = gradient_checkpointing and torch.is_grad_enabled()
        for i, block in enumerate(self.transformer_blocks):
            args = (hidden, encoder, temb, rope, attention_backend, bounded_logits,
                    None if lora is None else lora_layer(lora, i, lora_scale), self.tp, sp)
            if remat:
                hidden, encoder = checkpoint(block, *args, use_reentrant=False)
            else:
                hidden, encoder = block(*args)

        # Final norm (over the joint sequence with RoPE, the video tokens
        # without), adaLN (shift, scale), projection
        if cfg.use_rotary_positional_embeddings:
            text_len = encoder.shape[1]
            hidden = self.norm_final(torch.cat([encoder, hidden], dim=1))[:, text_len:]
        else:
            hidden = self.norm_final(hidden)
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
    biases 0, LayerNorm gains 1 and biases 0; the 2B's patch conv N(0,
    0.02^2) and its ``pos_embedding`` the sincos table. Built on ``device``
    directly."""
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
        elif isinstance(mod, nn.Conv2d):
            mod.weight.normal_(0.0, 0.02, generator=gen)
            mod.bias.zero_()
    if not cfg.use_rotary_positional_embeddings:
        model.patch_embed.pos_embedding.copy_(stored_pos_embedding(cfg))
    return model.eval().requires_grad_(False)
