"""T5 v1.1 encoder in PyTorch: the text branch of CogVideoX and DOVE.

Counterpart of ``dove_tpu/models/t5.py`` (T5-XXL, hidden 4096): RMS norms,
the relative-position bias of block 0 shared by every block, no 1/sqrt(d)
scale on the logits, gated tanh-GELU feed-forward. The numerics are the JAX
package's:

  * the embedding and the linears are in the model dtype, the norm gains and
    the bias table in fp32;
  * the RMS norm normalises in fp32, casts to x's dtype, then multiplies by
    the gain cast to x's dtype;
  * the logits are fp32 (products of the model dtype accumulated in fp32)
    with the fp32 bias added, the softmax is fp32 and its result is cast to
    v's dtype;
  * the buckets of the bias are computed on the host in float64
    (``_relative_position_bucket``): a float32 log flips buckets at their
    edges.

The module keeps its own parameter names (``embed``, ``rel_emb``,
``blocks.i.{ln0,q,k,v,o,ln1,wi_0,wi_1,wo}``, ``final_ln``); :func:`convert_t5`
reads the HF ``T5EncoderModel`` layout, both of its key spellings,
:func:`hf_state_dict` writes it, and :func:`load_t5` reads a diffusers
``text_encoder/`` folder. :class:`PromptEncoder`
tokenizes with the folder's own ``transformers`` tokenizer and pads to the
DiT's text length; T5 runs in bf16 whatever the pipeline's dtype, as the JAX
package's ``PromptEncoder`` does.
"""

from __future__ import annotations

import dataclasses
import json
import math
from pathlib import Path
from typing import Any, Mapping

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn


@dataclasses.dataclass(frozen=True)
class T5Config:
    vocab_size: int = 32128
    d_model: int = 4096
    d_kv: int = 64
    d_ff: int = 10240
    num_layers: int = 24
    num_heads: int = 64
    relative_attention_num_buckets: int = 32
    relative_attention_max_distance: int = 128
    layer_norm_epsilon: float = 1e-6


def t5_xxl() -> T5Config:
    return T5Config()


def t5_tiny() -> T5Config:
    """CPU-testable miniature with every architectural feature."""
    return T5Config(vocab_size=128, d_model=32, d_kv=8, d_ff=64, num_layers=2,
                    num_heads=4)


def _relative_position_bucket(relative_position: np.ndarray, num_buckets: int,
                              max_distance: int) -> np.ndarray:
    """Bidirectional T5 bucketing, on the host in float64."""
    num_buckets //= 2
    ret = (relative_position > 0).astype(np.int64) * num_buckets
    n = np.abs(relative_position)
    max_exact = num_buckets // 2
    is_small = n < max_exact
    val_large = max_exact + (
        np.log(n.clip(1) / max_exact) / math.log(max_distance / max_exact)
        * (num_buckets - max_exact)).astype(np.int64)
    val_large = np.minimum(val_large, num_buckets - 1)
    return ret + np.where(is_small, n, val_large)


def position_buckets(cfg: T5Config, seq_len: int) -> np.ndarray:
    """[S, S] bucket of each (query, key) pair."""
    ctx = np.arange(seq_len)[:, None]
    mem = np.arange(seq_len)[None, :]
    return _relative_position_bucket(mem - ctx, cfg.relative_attention_num_buckets,
                                     cfg.relative_attention_max_distance)


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float) -> torch.Tensor:
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps)).to(x.dtype) * weight.to(x.dtype)


class T5Block(nn.Module):
    def __init__(self, cfg: T5Config, dtype, device):
        super().__init__()
        inner = cfg.num_heads * cfg.d_kv
        kw = dict(dtype=dtype, device=device)
        self.ln0 = nn.Parameter(torch.ones(cfg.d_model, dtype=torch.float32, device=device))
        self.q = nn.Parameter(torch.zeros(inner, cfg.d_model, **kw))
        self.k = nn.Parameter(torch.zeros(inner, cfg.d_model, **kw))
        self.v = nn.Parameter(torch.zeros(inner, cfg.d_model, **kw))
        self.o = nn.Parameter(torch.zeros(cfg.d_model, inner, **kw))
        self.ln1 = nn.Parameter(torch.ones(cfg.d_model, dtype=torch.float32, device=device))
        self.wi_0 = nn.Parameter(torch.zeros(cfg.d_ff, cfg.d_model, **kw))
        self.wi_1 = nn.Parameter(torch.zeros(cfg.d_ff, cfg.d_model, **kw))
        self.wo = nn.Parameter(torch.zeros(cfg.d_model, cfg.d_ff, **kw))

    def attention(self, cfg: T5Config, x, bias, mask):
        B, S, _ = x.shape
        H, D = cfg.num_heads, cfg.d_kv

        def proj(w):
            return F.linear(x, w.to(x.dtype)).reshape(B, S, H, D).transpose(1, 2)

        q, k, v = proj(self.q), proj(self.k), proj(self.v)
        # no 1/sqrt(d): T5 folds the scale into its trained weights
        logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) + bias
        if mask is not None:
            logits = torch.where(mask[:, None, None, :], logits,
                                 torch.tensor(-1e9, dtype=logits.dtype, device=logits.device))
        probs = torch.softmax(logits, dim=-1).to(v.dtype)
        out = torch.matmul(probs, v).transpose(1, 2).reshape(B, S, H * D)
        return F.linear(out, self.o.to(x.dtype))

    def ffn(self, x):
        gate = F.gelu(F.linear(x, self.wi_0.to(x.dtype)), approximate="tanh")
        return F.linear(gate * F.linear(x, self.wi_1.to(x.dtype)), self.wo.to(x.dtype))

    def forward(self, cfg: T5Config, x, bias, mask):
        eps = cfg.layer_norm_epsilon
        x = x + self.attention(cfg, rms_norm(x, self.ln0, eps), bias, mask)
        return x + self.ffn(rms_norm(x, self.ln1, eps))


class T5Encoder(nn.Module):
    """``t5_encode`` as a module: token ids [B, S] -> features [B, S,
    d_model] in the model dtype; with ``attention_mask`` the masked keys are
    excluded and the masked positions zeroed."""

    def __init__(self, cfg: T5Config, dtype=torch.bfloat16, device="cpu"):
        super().__init__()
        self.cfg = cfg
        self.embed = nn.Parameter(torch.zeros(cfg.vocab_size, cfg.d_model, dtype=dtype,
                                              device=device))
        self.rel_emb = nn.Parameter(torch.zeros(
            cfg.relative_attention_num_buckets, cfg.num_heads, dtype=torch.float32,
            device=device))
        self.blocks = nn.ModuleList(T5Block(cfg, dtype, device)
                                    for _ in range(cfg.num_layers))
        self.final_ln = nn.Parameter(torch.ones(cfg.d_model, dtype=torch.float32,
                                                device=device))
        self._buckets: dict[tuple[int, str], torch.Tensor] = {}

    def position_bias(self, seq_len: int) -> torch.Tensor:
        """[1, heads, S, S] fp32 additive bias from block 0's table."""
        key = (seq_len, str(self.rel_emb.device))
        if key not in self._buckets:
            self._buckets[key] = torch.from_numpy(
                position_buckets(self.cfg, seq_len)).to(self.rel_emb.device)
        return self.rel_emb[self._buckets[key]].permute(2, 0, 1)[None].float()

    def forward(self, input_ids: torch.Tensor,
                attention_mask: torch.Tensor | None = None) -> torch.Tensor:
        x = self.embed[input_ids]
        bias = self.position_bias(input_ids.shape[1])
        mask = attention_mask.bool() if attention_mask is not None else None
        for blk in self.blocks:
            x = blk(self.cfg, x, bias, mask)
        x = rms_norm(x, self.final_ln, self.cfg.layer_norm_epsilon)
        if mask is not None:
            x = x * mask[..., None].to(x.dtype)
        return x


def init_t5(cfg: T5Config, seed: int = 0, dtype=torch.float32, device="cpu") -> T5Encoder:
    """Seeded weights at HF ``T5PreTrainedModel``'s init scales: q
    N(0, 1/(d_model d_kv)) (the attention's 1/sqrt(d) folded in, as trained
    T5 folds it), k and v N(0, 1/d_model), o N(0, 1/(heads d_kv)), wi_0 and
    wi_1 N(0, 1/d_model), wo N(0, 1/d_ff), the bias table N(0, 1/d_model), the
    embedding N(0, 1), unit gains; drawn in fp32 on ``device`` from a
    generator seeded with ``seed`` and cast, so every dtype gets the same
    model rounded."""
    model = T5Encoder(cfg, dtype, device)
    inner = cfg.num_heads * cfg.d_kv
    std = {"embed": 1.0, "rel_emb": cfg.d_model ** -0.5,
           "q": (cfg.d_model * cfg.d_kv) ** -0.5, "k": cfg.d_model ** -0.5,
           "v": cfg.d_model ** -0.5, "o": inner ** -0.5, "wi_0": cfg.d_model ** -0.5,
           "wi_1": cfg.d_model ** -0.5, "wo": cfg.d_ff ** -0.5}
    gen = torch.Generator(device=device).manual_seed(seed)
    with torch.no_grad():
        for name, p in model.named_parameters():
            leaf = name.rsplit(".", 1)[-1]
            if leaf in std:  # one tensor at a time
                p.copy_(torch.randn(p.shape, generator=gen, device=device) * std[leaf])
    return model.eval().requires_grad_(False)


# ---------------------------------------------------------------------------
# Weights: HF transformers layout, diffusers folders
# ---------------------------------------------------------------------------

_HF_BLOCK = {
    "ln0": "layer.0.layer_norm", "q": "layer.0.SelfAttention.q",
    "k": "layer.0.SelfAttention.k", "v": "layer.0.SelfAttention.v",
    "o": "layer.0.SelfAttention.o", "ln1": "layer.1.layer_norm",
    "wi_0": "layer.1.DenseReluDense.wi_0", "wi_1": "layer.1.DenseReluDense.wi_1",
    "wo": "layer.1.DenseReluDense.wo",
}


def hf_to_port(tensors: Mapping[str, Any], cfg: T5Config) -> dict[str, Any]:
    """An HF ``T5EncoderModel`` state dict -> the port's names. The HF
    layout is torch's own ([out, in] linears), so the tensors pass as they
    are. Both spellings are read: ``shared.weight`` or
    ``encoder.embed_tokens.weight``, ``encoder.block.i`` or ``block.i``."""

    def key(name: str) -> str:
        return name if name in tensors else f"encoder.{name}"

    out = {"embed": tensors["shared.weight" if "shared.weight" in tensors
                            else "encoder.embed_tokens.weight"],
           "rel_emb": tensors[key("block.0.layer.0.SelfAttention.relative_attention_bias.weight")],
           "final_ln": tensors[key("final_layer_norm.weight")]}
    for i in range(cfg.num_layers):
        b = (f"encoder.block.{i}"
             if f"encoder.block.{i}.layer.0.SelfAttention.q.weight" in tensors
             else f"block.{i}")
        for ours, theirs in _HF_BLOCK.items():
            out[f"blocks.{i}.{ours}"] = tensors[f"{b}.{theirs}.weight"]
    return out


def hf_state_dict(model: T5Encoder) -> dict[str, torch.Tensor]:
    """The encoder's tensors under HF ``T5EncoderModel``'s names (the
    ``shared.weight`` / ``encoder.block.i`` spelling): what a diffusers
    ``text_encoder/`` holds."""
    theirs = {"embed": "shared", "final_ln": "encoder.final_layer_norm",
              "rel_emb": "encoder.block.0.layer.0.SelfAttention.relative_attention_bias"}
    out = {}
    for name, t in model.state_dict().items():
        if name in theirs:
            out[f"{theirs[name]}.weight"] = t
        else:
            _, i, ours = name.split(".")
            out[f"encoder.block.{i}.{_HF_BLOCK[ours]}.weight"] = t
    return out


def convert_t5(tensors: Mapping[str, Any], cfg: T5Config, dtype=torch.bfloat16,
               device="cpu") -> T5Encoder:
    """An HF ``T5EncoderModel`` state dict (tensors or NumPy arrays) -> the
    encoder in ``dtype`` (norm gains and the bias table fp32)."""
    model = T5Encoder(cfg, dtype, device)
    state = {k: v if isinstance(v, torch.Tensor) else torch.tensor(np.asarray(v))
             for k, v in hf_to_port(tensors, cfg).items()}
    model.load_state_dict(state)
    return model.eval().requires_grad_(False)


def _config_from_json(path: Path) -> T5Config:
    raw = json.loads(path.read_text())
    d = T5Config()
    return T5Config(**{f.name: raw.get(f.name, getattr(d, f.name))
                       for f in dataclasses.fields(T5Config)})


def load_t5(model_dir: str | Path, cfg: T5Config | None = None, dtype=torch.bfloat16,
            device="cpu") -> tuple[T5Encoder, T5Config]:
    """The encoder of a diffusers checkpoint's ``text_encoder/`` (or of
    ``model_dir`` itself), sharded files included; its ``config.json``
    gives the config unless ``cfg`` does, else T5-XXL."""
    from dove_tpu_torch.weights import load_safetensors_dir

    model_dir = Path(model_dir)
    sub = model_dir / "text_encoder" if (model_dir / "text_encoder").exists() else model_dir
    if cfg is None and (sub / "config.json").exists():
        cfg = _config_from_json(sub / "config.json")
    cfg = cfg or t5_xxl()
    return convert_t5(load_safetensors_dir(sub), cfg, dtype, device), cfg


# ---------------------------------------------------------------------------
# Prompt embedding (tokenize + encode + pad to max_text_seq_length)
# ---------------------------------------------------------------------------

class PromptEncoder:
    """The folder's tokenizer + T5, giving CogVideoX-style prompt embeddings
    of a fixed length.

    As in CogVideoX and the JAX package, the encoder sees the input ids
    only: no attention mask, so the pad positions get embeddings of their
    own, which the DiT attends to. ``use_attention_mask=True`` is the
    masked variant. T5 runs in ``dtype`` (bf16), never in an fp16
    pipeline's dtype; callers cast the embedding afterwards."""

    def __init__(self, model_dir: str | Path, max_length: int = 226,
                 dtype=torch.bfloat16, use_attention_mask: bool = False, device=None):
        from transformers import AutoTokenizer

        from dove_tpu_torch.pipeline import resolve_device

        self.device = resolve_device(device)
        model_dir = Path(model_dir)
        tok_dir = model_dir / "tokenizer" if (model_dir / "tokenizer").exists() else model_dir
        self.tokenizer = AutoTokenizer.from_pretrained(str(tok_dir))
        self.model, self.cfg = load_t5(model_dir, dtype=dtype, device=self.device)
        self.max_length = max_length
        self.use_attention_mask = use_attention_mask

    @torch.no_grad()
    def __call__(self, prompt: str) -> np.ndarray:
        """[max_length, d_model] float32 on the host."""
        enc = self.tokenizer(prompt, padding="max_length", max_length=self.max_length,
                             truncation=True, add_special_tokens=True, return_tensors="np")
        ids = torch.from_numpy(np.asarray(enc["input_ids"], np.int64)).to(self.device)
        mask = None
        if self.use_attention_mask:
            mask = torch.from_numpy(np.asarray(enc["attention_mask"])).to(self.device)
        return self.model(ids, mask)[0].float().cpu().numpy()
