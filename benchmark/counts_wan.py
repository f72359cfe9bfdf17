"""Operations and bytes of one Wan2.1 clip, from its configuration and shapes
alone (``counts.py``'s conventions: an operation is a multiply or an add,
each input read once and each output written once).

The DiT: per block the self-attention's q, k, v, o and the cross-attention's
q and o over the video tokens, its k and v over the text slots, the MLP, and
the attention itself (Q K^T and P V); the patch, text, time and head
projections. The VAE: every convolution of the encoder and the decoder at the
frames it computes in the release's chunk rule (the 3x3x3 causal convs, the
shortcuts' and ``conv1`` / ``conv2``'s 1x1x1, the resamplers' per-frame 3x3
and temporal 3x1x1 convs), and the middle's attention (its 1x1 convs and one
head of C channels over each frame's positions).
"""

from __future__ import annotations

import math

from benchmark.counts import Work, attention, conv

ELEM = 2  # bf16


def is_wan(config: dict) -> bool:
    return "num_heads" in config["dit"]


def clip_shapes(config: dict, mix: dict) -> dict:
    """A clip's shapes on the staged path: padded to (F - 1) % 8 == 0 and to
    multiples of 16 pixels, upscaled; its latent and the DiT's tokens."""
    v, u = config["vae"], config["upscale"]
    s = 2 ** (len(v["dim_mult"]) - 1)
    tr = 2 ** sum(bool(t) for t in v["temperal_downsample"])
    frames, h, w = mix["frames"], mix["height"], mix["width"]
    fp = frames + (-(frames - 1)) % 8
    hu, wu = (h + (-h) % 16) * u, (w + (-w) % 16) * u
    sh = dict(frames=fp, height=hu, width=wu, lat_frames=(fp - 1) // tr + 1,
              lat_h=hu // s, lat_w=wu // s)
    pt, ph, pw = config["dit"]["patch_size"]
    sh["tokens"] = (sh["lat_frames"] // pt) * (sh["lat_h"] // ph) * (sh["lat_w"] // pw)
    return sh


def dit_work(config: dict, mix: dict) -> dict[str, Work]:
    """One DiT pass by part: "linear", "self_attn", "cross_attn"."""
    c = config["dit"]
    d, f, L = c["dim"], c["ffn_dim"], c["text_len"]
    S = clip_shapes(config, mix)["tokens"]
    hd = d // c["num_heads"]
    per_block = (2.0 * S * d * d * 6 + 2.0 * L * d * d * 2 + 2.0 * S * d * f * 2)
    edges = (2.0 * S * d * c["in_dim"] * math.prod(c["patch_size"])
             + 2.0 * L * d * (c["text_dim"] + d)
             + 2.0 * (c["freq_dim"] * d + d * d + d * 6 * d)
             + 2.0 * S * d * c["out_dim"] * math.prod(c["patch_size"]))
    n = c["num_layers"]
    sa = attention(1, c["num_heads"], S, S, hd, ELEM)
    ca = attention(1, c["num_heads"], S, L, hd, ELEM)
    return {"linear": Work(n * per_block + edges, 0.0),
            "self_attn": Work(sa.ops * n, sa.nbytes * n),
            "cross_attn": Work(ca.ops * n, ca.nbytes * n)}


def vae_work(config: dict, mix: dict, attn: bool = True) -> list[Work]:
    """Every convolution and the middle attentions of the encode and the
    decode of one clip, in the order they run; the convolutions alone
    where ``attn`` is false."""
    v = config["vae"]
    sh = clip_shapes(config, mix)
    dims = [v["base_dim"] * u for u in [1] + list(v["dim_mult"])]
    out: list[Work] = []
    shape = [sh["frames"], sh["height"], sh["width"]]

    def vox():
        return shape[0] * shape[1] * shape[2]

    def add(ci, co, k, v_in=None, v_out=None):
        vo = vox() if v_out is None else v_out
        out.append(conv(ci, co, k, vox() if v_in is None else v_in, vo, ELEM))

    def res(ci, co):
        add(ci, co, 27)
        add(co, co, 27)
        if ci != co:
            add(ci, co, 1)

    def mid(c):
        res(c, c)
        hw = shape[1] * shape[2]
        add(c, 3 * c, 1)
        if attn:
            out.append(attention(shape[0], 1, hw, hw, c, ELEM))
        add(c, c, 1)
        res(c, c)

    z = v["z_dim"]
    add(3, dims[0], 27)
    n = len(v["dim_mult"])
    for i, (ci, co) in enumerate(zip(dims[:-1], dims[1:])):
        for _ in range(v["num_res_blocks"]):
            res(ci, co)
            ci = co
        if i != n - 1:
            v_in = vox()
            shape[1], shape[2] = shape[1] // 2, shape[2] // 2
            add(co, co, 9, v_in=v_in)
            if v["temperal_downsample"][i]:  # the first frame passes, pairs after
                t_out = (shape[0] - 1) // 2
                add(co, co, 3, v_out=t_out * shape[1] * shape[2])
                shape[0] = 1 + t_out
    mid(dims[-1])
    add(dims[-1], 2 * z, 27)
    add(2 * z, 2 * z, 1)
    # the decoder, from the latent
    mult = list(v["dim_mult"])
    dd = [v["base_dim"] * u for u in [mult[-1]] + mult[::-1]]
    up = list(v["temperal_downsample"])[::-1]
    add(z, z, 1)
    add(z, dd[0], 27)
    mid(dd[0])
    for i, (ci, co) in enumerate(zip(dd[:-1], dd[1:])):
        if i in (1, 2, 3):
            ci //= 2
        for _ in range(v["num_res_blocks"] + 1):
            res(ci, co)
            ci = co
        if i != n - 1:
            if up[i]:  # the first frame passes, every later one makes two
                t_in = shape[0] - 1
                add(co, 2 * co, 3, v_in=t_in * shape[1] * shape[2],
                    v_out=2 * t_in * shape[1] * shape[2])
                shape[0] = 1 + 2 * t_in
            shape[1], shape[2] = 2 * shape[1], 2 * shape[2]
            add(co, co // 2, 9, v_in=vox() // 4)
    add(dd[-1], 3, 27)
    return out


def clip_work(config: dict, mix: dict) -> dict[str, Work]:
    """One clip by part: the DiT's "linear", "self_attn", "cross_attn", and
    "vae" (every convolution and attention of the encode and decode)."""
    work = dit_work(config, mix)
    vae = Work()
    for w in vae_work(config, mix):
        vae += w
    work["vae"] = vae
    return work
