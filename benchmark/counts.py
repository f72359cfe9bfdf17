"""Operations and bytes of the work a cell asks for, from its configuration
and shapes alone: never from the program's counters or modules, so the same
work is counted whatever implements it. An operation is a multiply or an add
(a multiply-add is two). Each input is read once and each output written
once; window overlap and recomputation count as waste, not as work.
"""

from __future__ import annotations

import dataclasses
import math


@dataclasses.dataclass
class Work:
    ops: float = 0.0
    nbytes: float = 0.0

    def __iadd__(self, other: "Work") -> "Work":
        self.ops += other.ops
        self.nbytes += other.nbytes
        return self


def conv(c_in: int, c_out: int, kvol: int, vox_in: int, vox_out: int, elem: int) -> Work:
    """One convolution: 2 c_in c_out kvol per output voxel; input, weights
    and output each moved once at ``elem`` bytes."""
    return Work(2.0 * c_in * c_out * kvol * vox_out,
                elem * (c_in * vox_in + c_in * c_out * kvol + c_out * vox_out))


def attention(batch: int, heads: int, sq: int, skv: int, dim: int, elem: int) -> Work:
    """Forward attention: Q K^T and P V, 2 sq skv dim each per head; q, k,
    v read and o written once."""
    return Work(4.0 * batch * heads * sq * skv * dim,
                elem * batch * heads * dim * (2 * sq + 2 * skv))


def vae_convs(c: dict, frames: int, h: int, w: int, part: str, elem: int) -> list[Work]:
    """Every convolution of the VAE's encoder (``part="encoder"``, pixels of
    ``frames`` x h x w in) or decoder (latents of ``frames`` x h x w in)."""
    ch = list(c["block_out_channels"])
    n, tl = len(ch), int(math.log2(c["temporal_compression_ratio"]))
    out: list[Work] = []
    shape = [frames, h, w]

    def vox():
        return shape[0] * shape[1] * shape[2]

    def add(ci, co, k, v_in=None):
        v = vox()
        out.append(conv(ci, co, k, v if v_in is None else v_in, v, elem))

    def res(ci, co, zq_vox=None):
        if zq_vox is not None:  # spatial norms' 1x1x1 convs
            for cc in (ci, co):
                out.extend([conv(c["latent_channels"], cc, 1, zq_vox, zq_vox, elem)] * 2)
        add(ci, co, 27)
        add(co, co, 27)
        if ci != co:
            add(ci, co, 1)

    if part == "encoder":
        add(c["in_channels"], ch[0], 27)
        for i in range(n):
            for j in range(c["layers_per_block"]):
                res(ch[max(i - 1, 0)] if j == 0 else ch[i], ch[i])
            if i < n - 1:
                if i < tl:
                    shape[0] = 1 + (shape[0] - 1) // 2 if shape[0] % 2 else shape[0] // 2
                v_in = vox()
                shape[1], shape[2] = shape[1] // 2, shape[2] // 2
                add(ch[i], ch[i], 9, v_in)
        for _ in range(2):
            res(ch[-1], ch[-1])
        add(ch[-1], 2 * c["latent_channels"], 27)
        return out
    zq = vox()
    rev = ch[::-1]
    add(c["latent_channels"], rev[0], 27)
    for _ in range(2):
        res(rev[0], rev[0], zq)
    for i in range(n):
        for j in range(c["layers_per_block"] + 1):
            res(rev[max(i - 1, 0)] if j == 0 else rev[i], rev[i], zq)
        if i < n - 1:
            if i < tl:
                shape[0] = 1 + 2 * (shape[0] - 1) if shape[0] % 2 else 2 * shape[0]
            shape[1], shape[2] = 2 * shape[1], 2 * shape[2]
            add(rev[i], rev[i], 9)
    out.extend([conv(c["latent_channels"], rev[-1], 1, zq, zq, elem)] * 2)
    add(rev[-1], c["out_channels"], 27)
    return out


def dit_tokens(c: dict, latent_frames: int, h: int, w: int) -> tuple[int, int]:
    """(video tokens, text tokens) of one DiT pass over a latent of
    ``latent_frames`` x h x w, padded to whole temporal patches."""
    pt = c["patch_size_t"]
    f = latent_frames + ((pt - latent_frames % pt) % pt if pt else 0)
    p = c["patch_size"]
    return f // (pt or 1) * (h // p) * (w // p), c["max_text_seq_length"]


def dit_linear_ops(c: dict, batch: int, video: int, text: int) -> float:
    """The DiT's linear layers over one forward: per block q, k, v, out and
    the MLP over the joint sequence, the adaLN projections, and the
    embeddings and output projection."""
    D, T = c["num_attention_heads"] * c["attention_head_dim"], c["time_embed_dim"]
    S = video + text
    p, pt = c["patch_size"], c["patch_size_t"] or 1
    per_block = 2.0 * S * D * D * (4 + 2 * c["ff_mult"]) + 2 * (2.0 * T * 6 * D)
    edges = (2.0 * video * D * c["in_channels"] * pt * p * p
             + 2.0 * text * D * c["text_embed_dim"]
             + 2.0 * video * D * c["out_channels"] * pt * p * p
             + 2.0 * (D * T + T * T + T * 2 * D))
    return batch * (c["num_layers"] * per_block + edges)


def dit_attention(c: dict, batch: int, video: int, text: int, elem: int) -> Work:
    """Every layer's joint attention over one forward."""
    S = video + text
    w = attention(batch, c["num_attention_heads"], S, S, c["attention_head_dim"], elem)
    return Work(w.ops * c["num_layers"], w.nbytes * c["num_layers"])


def staged_shapes(cfg: dict, frames: int, h: int, w: int) -> dict:
    """A clip's shapes on the staged path: padded to (F - 1) % 8 == 0 and to
    multiples of 16 pixels, upscaled, and its latent."""
    fp = frames + (-(frames - 1)) % 8
    u, s = cfg["upscale"], 2 ** (len(cfg["vae"]["block_out_channels"]) - 1)
    hu, wu = (h + (-h) % 16) * u, (w + (-w) % 16) * u
    return dict(frames=fp, height=hu, width=wu,
                lat_frames=(fp - 1) // cfg["vae"]["temporal_compression_ratio"] + 1,
                lat_h=hu // s, lat_w=wu // s)


ELEM = {"bfloat16": 2, "float16": 2, "float32": 4}
DIT_INT8 = ("int8", "int8-dit", "int8-dit-dec")  # W8A8 linears, int8 Q K^T
VAE_INT8 = ("int8", "int8-vae", "int8-dit-dec")


def clip_work(config: dict, mix: dict) -> dict[str, tuple[Work, str]]:
    """One clip of a serving mix, by part: (work, the dtype of its peak)."""
    dt, mode = config["dtype"], mix.get("quantize")
    e = ELEM[dt]
    sh = staged_shapes(config, mix["frames"], mix["height"], mix["width"])
    video, text = dit_tokens(config["dit"], sh["lat_frames"], sh["lat_h"], sh["lat_w"])
    att = dit_attention(config["dit"], 1, video, text, e)
    half = Work(att.ops / 2, att.nbytes / 2)
    lin = dit_linear_ops(config["dit"], 1, video, text)
    enc = Work()
    for w in vae_convs(config["vae"], sh["frames"], sh["height"], sh["width"], "encoder", e):
        enc += w
    dec = Work()
    for w in vae_convs(config["vae"], sh["lat_frames"], sh["lat_h"], sh["lat_w"], "decoder", e):
        dec += w
    q = "int8" if mode in DIT_INT8 else dt
    return {"enc": (enc, "int8" if mode in ("int8", "int8-vae") else dt),
            "dec": (dec, "int8" if mode in VAE_INT8 else dt),
            "dit_linear": (Work(lin, 0.0), q), "attn_qk": (half, q), "attn_pv": (half, dt)}


def train_step_work(config: dict, mix: dict) -> dict[str, tuple[Work, str]]:
    """One stage-1 LoRA step, by part, with no recomputation: the encode of
    the LQ and HQ clips; the DiT forward, its backward to the activations
    (the base weights are frozen) and the LoRA factors' own products
    (forward, backward to the input, and their two gradients); attention
    forward (Q K^T, P V) and backward (dV, dP, dQ, dK)."""
    dt = config["dtype"]
    e, c = ELEM[dt], config["dit"]
    B, (frames, h, w) = mix["batch_size"], mix["resolution"]
    enc = Work()
    for x in vae_convs(config["vae"], frames, h, w, "encoder", e):
        enc += x
    enc = Work(enc.ops * 2 * B, enc.nbytes * 2 * B)
    s = 2 ** (len(config["vae"]["block_out_channels"]) - 1)
    lat = (frames - 1) // config["vae"]["temporal_compression_ratio"] + 1
    video, text = dit_tokens(c, lat, h // s, w // s)
    D, tokens = c["num_attention_heads"] * c["attention_head_dim"], B * (video + text)
    lin = 2 * dit_linear_ops(c, B, video, text)
    lora = 4 * c["num_layers"] * 12.0 * tokens * D * mix["rank"]
    att = dit_attention(c, B, video, text, e)
    return {"encode": (enc, dt), "dit_linear": (Work(lin + lora, 0.0), dt),
            "attention": (Work(att.ops * 3, att.nbytes * 3), dt)}
