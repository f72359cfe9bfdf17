"""The port's CLIP towers, tokenizer and CLIP-IQA against dove_tpu's (CPU).

At the tiny config of tests/test_clip.py (and a width-16 RN50 tower), the
same seeded parameters through both packages: image and text features
within 1e-5 RMS-relative; CLIP-IQA within 1e-5 absolute, through each
package's own loader of one checkpoint the test writes (a HuggingFace
snapshot for the ViT, an OpenAI ``.pt`` for the RN50), the two loaders
giving equal tensors; the port's tokenizer giving ``transformers``' ids on
the prompts and on other strings; the port's CLIP-IQA running with
``transformers`` and ``cv2`` absent; and ``python -m
dove_tpu_torch.eval_metrics --metrics clipiqa`` with no --gt_dir against
``scripts/eval_metrics.py`` on the same PNG folders (schema and scores).
"""

from __future__ import annotations

import dataclasses
import json
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dove_tpu.eval import clip as jclip
from dove_tpu_torch import safetensors_io
from dove_tpu_torch.eval import clip as tclip
from dove_tpu_torch.eval import clip_tokenizer
from test_clip import TINY
from torch_threads import two_torch_threads  # noqa: F401 (autouse)

FEATURE_TOL = 1e-5  # RMS-relative
SCORE_ATOL = 1e-5
WORDS = ("good", "bad", "photo")


def _cfg(cfg) -> tclip.CLIPConfig:
    return tclip.CLIPConfig(**dataclasses.asdict(cfg))


def _rel_rms(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.sqrt(np.mean((a - b) ** 2) / np.mean(b ** 2)))


def _noisy(tree, seed: int):
    """A JAX parameter tree with seeded noise on every leaf, so that norms
    and biases are not ones and zeros."""
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda a: (np.asarray(a, np.float32)
                   + rng.normal(0, 0.02, np.shape(a)).astype(np.float32))
        if np.ndim(a) else a, tree)


@pytest.fixture(scope="module")
def vit_params():
    return _noisy(jclip.init_clip_params(jax.random.PRNGKey(0), TINY), 1)


def _frames(seed: int, shape) -> np.ndarray:
    return np.random.default_rng(seed).uniform(0, 1, shape).astype(np.float32)


def test_vit_and_text_towers_match_jax(vit_params):
    model = tclip.from_jax_clip(vit_params, _cfg(TINY))
    x = np.random.default_rng(2).normal(size=(3, 32, 32, 3)).astype(np.float32)
    ids = np.asarray([[5, 9, 63, 0, 0, 0, 0, 0], [1, 2, 3, 63, 63, 2, 1, 0]], np.int32)
    with torch.no_grad():
        img = model.encode_image(torch.from_numpy(x)).numpy()
        txt = model.encode_text(torch.from_numpy(ids).long()).numpy()
    assert _rel_rms(img, jclip.encode_image(TINY, vit_params, jnp.asarray(x))) <= FEATURE_TOL
    assert _rel_rms(txt, jclip.encode_text(TINY, vit_params, jnp.asarray(ids))) <= FEATURE_TOL


def test_rn50_tower_matches_jax(vit_params):
    params = dict(vit_params, vision=_noisy(
        jclip.init_clip_rn50_params(jax.random.PRNGKey(3), width=16), 4)["vision"])
    model = tclip.from_jax_clip_rn50(params, _cfg(TINY))
    for seed, shape in ((5, (2, 70, 94, 3)), (6, (1, 64, 96, 3))):
        x = np.random.default_rng(seed).normal(size=shape).astype(np.float32)
        with torch.no_grad():
            ours = model.encode_image(torch.from_numpy(x)).numpy()
        assert _rel_rms(ours, jclip.encode_image_rn50(params, jnp.asarray(x))) <= FEATURE_TOL


def test_tokenizer_matches_transformers(tmp_path):
    from transformers import CLIPTokenizer

    clip_tokenizer.write_bpe_files(tmp_path, WORDS + ("dog", "café"))
    ref = CLIPTokenizer(str(tmp_path / "vocab.json"), str(tmp_path / "merges.txt"))
    ours = clip_tokenizer.CLIPTokenizer.from_dir(tmp_path)
    texts = [jclip.GOOD_PROMPT, jclip.BAD_PROMPT, "A photo of a dog!",
             "  Bad \t PHOTO.\n", "good's 42 photos_ok", "naïve CAFÉ", "日本 photo",
             "<|startoftext|>good<|endoftext|>", "it'll be bad-ish..."]
    for text in texts:
        assert ours.encode(text) == ref(text)["input_ids"], text
    padded = ref(texts[:2], padding="max_length", max_length=12)["input_ids"]
    assert ours(texts[:2], max_length=12) == padded


def _hf_snapshot(params, cfg, out_dir) -> None:
    """The JAX tree written as a HuggingFace CLIPModel snapshot."""
    sd, v, t = {}, params["vision"], params["text"]

    def ln(name, p):
        sd[f"{name}.weight"], sd[f"{name}.bias"] = p["scale"], p["bias"]

    def block(prefix, p):
        ln(f"{prefix}.layer_norm1", p["ln1"])
        ln(f"{prefix}.layer_norm2", p["ln2"])
        for ours, hf in (("q", "q_proj"), ("k", "k_proj"), ("v", "v_proj"),
                         ("out", "out_proj")):
            sd[f"{prefix}.self_attn.{hf}.weight"] = p["attn"][ours]["kernel"].T
            sd[f"{prefix}.self_attn.{hf}.bias"] = p["attn"][ours]["bias"]
        for name in ("fc1", "fc2"):
            sd[f"{prefix}.mlp.{name}.weight"] = p[name]["kernel"].T
            sd[f"{prefix}.mlp.{name}.bias"] = p[name]["bias"]

    vis, txt = "vision_model", "text_model"
    sd[f"{vis}.embeddings.patch_embedding.weight"] = v["patch_embed"]["kernel"].transpose(3, 2, 0, 1)
    sd[f"{vis}.embeddings.class_embedding"] = v["class_embed"]
    sd[f"{vis}.embeddings.position_embedding.weight"] = v["pos_embed"]
    ln(f"{vis}.pre_layrnorm", v["pre_ln"])
    ln(f"{vis}.post_layernorm", v["post_ln"])
    for i, p in enumerate(v["blocks"]):
        block(f"{vis}.encoder.layers.{i}", p)
    sd[f"{txt}.embeddings.token_embedding.weight"] = t["token_embed"]
    sd[f"{txt}.embeddings.position_embedding.weight"] = t["pos_embed"]
    ln(f"{txt}.final_layer_norm", t["final_ln"])
    for i, p in enumerate(t["blocks"]):
        block(f"{txt}.encoder.layers.{i}", p)
    sd["visual_projection.weight"] = params["visual_projection"].T
    sd["text_projection.weight"] = params["text_projection"].T
    sd["logit_scale"] = np.asarray(params["logit_scale"], np.float32)
    safetensors_io.save_file({k: torch.tensor(np.ascontiguousarray(a, np.float32))
                              for k, a in sd.items()}, out_dir / "model.safetensors")
    (out_dir / "config.json").write_text(json.dumps({
        "projection_dim": cfg.projection_dim,
        "vision_config": {"image_size": cfg.image_size, "patch_size": cfg.patch_size,
                          "hidden_size": cfg.vision_width,
                          "num_hidden_layers": cfg.vision_layers,
                          "num_attention_heads": cfg.vision_heads},
        "text_config": {"vocab_size": cfg.vocab_size,
                        "max_position_embeddings": cfg.context_length,
                        "hidden_size": cfg.text_width,
                        "num_hidden_layers": cfg.text_layers,
                        "num_attention_heads": cfg.text_heads}}))


def _assert_same_module(a: torch.nn.Module, b: torch.nn.Module) -> None:
    sa, sb = a.state_dict(), b.state_dict()
    assert sa.keys() == sb.keys()
    for k in sa:
        assert torch.equal(sa[k], sb[k]), k


def test_clipiqa_vit_matches_jax(tmp_path, monkeypatch):
    """One HF snapshot: the port's loader equals JAX's loader carried
    across; the two CLIP-IQA callables agree on a clip."""
    vocab = clip_tokenizer.write_bpe_files(tmp_path, WORDS)
    cfg = dataclasses.replace(TINY, vocab_size=vocab)
    params = _noisy(jclip.init_clip_params(jax.random.PRNGKey(7), cfg), 8)
    _hf_snapshot(params, cfg, tmp_path)
    _assert_same_module(
        tclip.load_clip(tmp_path),
        tclip.from_jax_clip(jclip.load_clip(tmp_path)[1], _cfg(cfg)))
    frames = _frames(9, (3, 40, 56, 3))
    monkeypatch.setenv("DOVE_CLIP_WEIGHTS", str(tmp_path))
    ref = jclip.clipiqa_metric()(frames)
    ours = tclip.clipiqa_metric(device="cpu")(frames)
    assert 0.0 < ours < 1.0
    assert abs(ours - ref) <= SCORE_ATOL, (ours, ref)


def _openai_rn50(path, vocab: int, seed: int, width: int = 16, text_width: int = 64,
                 embed: int = 32, context: int = 8) -> None:
    """A seeded OpenAI-layout CLIP RN50 state dict (random BatchNorm
    statistics, one text layer), saved with torch.save."""
    g = torch.Generator().manual_seed(seed)
    sd = {}

    def rnd(*shape, s=0.1):
        return torch.randn(*shape, generator=g) * s

    def bn(prefix, c):
        sd[f"{prefix}.weight"] = 1 + rnd(c)
        sd[f"{prefix}.bias"] = rnd(c)
        sd[f"{prefix}.running_mean"] = rnd(c)
        sd[f"{prefix}.running_var"] = torch.rand(c, generator=g) + 0.5
        sd[f"{prefix}.num_batches_tracked"] = torch.tensor(0)

    def conv(key, cout, cin, k):
        sd[key] = rnd(cout, cin, k, k, s=(k * k * cin) ** -0.5)

    conv("visual.conv1.weight", width // 2, 3, 3)
    bn("visual.bn1", width // 2)
    conv("visual.conv2.weight", width // 2, width // 2, 3)
    bn("visual.bn2", width // 2)
    conv("visual.conv3.weight", width, width // 2, 3)
    bn("visual.bn3", width)
    cin = width
    for li, n in enumerate(tclip.RN50_LAYERS):
        planes = width * 2 ** li
        for bi in range(n):
            pre = f"visual.layer{li + 1}.{bi}"
            c_in = cin if bi == 0 else 4 * planes
            conv(f"{pre}.conv1.weight", planes, c_in, 1)
            bn(f"{pre}.bn1", planes)
            conv(f"{pre}.conv2.weight", planes, planes, 3)
            bn(f"{pre}.bn2", planes)
            conv(f"{pre}.conv3.weight", 4 * planes, planes, 1)
            bn(f"{pre}.bn3", 4 * planes)
            if bi == 0:
                conv(f"{pre}.downsample.0.weight", 4 * planes, c_in, 1)
                bn(f"{pre}.downsample.1", 4 * planes)
        cin = 4 * planes
    sd["visual.attnpool.positional_embedding"] = rnd(5, cin)
    for name, out in (("q", cin), ("k", cin), ("v", cin), ("c", embed)):
        sd[f"visual.attnpool.{name}_proj.weight"] = rnd(out, cin, s=cin ** -0.5)
        sd[f"visual.attnpool.{name}_proj.bias"] = rnd(out)
    tw = text_width
    sd["token_embedding.weight"] = rnd(vocab, tw, s=0.02)
    sd["positional_embedding"] = rnd(context, tw, s=0.01)
    pre = "transformer.resblocks.0"
    for ln in ("ln_1", "ln_2"):
        sd[f"{pre}.{ln}.weight"], sd[f"{pre}.{ln}.bias"] = 1 + rnd(tw), rnd(tw)
    sd[f"{pre}.attn.in_proj_weight"] = rnd(3 * tw, tw, s=tw ** -0.5)
    sd[f"{pre}.attn.in_proj_bias"] = rnd(3 * tw)
    sd[f"{pre}.attn.out_proj.weight"] = rnd(tw, tw, s=tw ** -0.5)
    sd[f"{pre}.attn.out_proj.bias"] = rnd(tw)
    sd[f"{pre}.mlp.c_fc.weight"] = rnd(4 * tw, tw, s=tw ** -0.5)
    sd[f"{pre}.mlp.c_fc.bias"] = rnd(4 * tw)
    sd[f"{pre}.mlp.c_proj.weight"] = rnd(tw, 4 * tw, s=(4 * tw) ** -0.5)
    sd[f"{pre}.mlp.c_proj.bias"] = rnd(tw)
    sd["ln_final.weight"], sd["ln_final.bias"] = 1 + rnd(tw), rnd(tw)
    sd["text_projection"] = rnd(tw, embed, s=tw ** -0.5)
    sd["logit_scale"] = torch.tensor(float(np.log(100.0)))
    torch.save(sd, path)


def test_clipiqa_rn50_matches_jax(tmp_path, monkeypatch):
    """One OpenAI .pt with the tokenizer files beside it: the loaders agree
    (BatchNorms folded alike), the scores agree at the frames' own size."""
    vocab = clip_tokenizer.write_bpe_files(tmp_path, WORDS)
    path = tmp_path / "RN50.pt"
    _openai_rn50(path, vocab, seed=10)
    jcfg, jparams = jclip.load_clip_rn50(path)
    _assert_same_module(tclip.load_clip_rn50(path),
                        tclip.from_jax_clip_rn50(jparams, _cfg(jcfg)))
    frames = _frames(11, (2, 64, 96, 3))
    monkeypatch.setenv("DOVE_CLIP_WEIGHTS", str(path))
    monkeypatch.delenv("DOVE_CLIP_TOKENIZER", raising=False)
    ref = jclip.clipiqa_metric()(frames)
    ours = tclip.clipiqa_metric(device="cpu")(frames)
    assert 0.0 < ours < 1.0
    assert abs(ours - ref) <= SCORE_ATOL, (ours, ref)


def test_clipiqa_runs_without_transformers_or_cv2(tmp_path, monkeypatch):
    vocab = clip_tokenizer.write_bpe_files(tmp_path, WORDS)
    cfg = dataclasses.replace(TINY, vocab_size=vocab)
    _hf_snapshot(_noisy(jclip.init_clip_params(jax.random.PRNGKey(12), cfg), 13),
                 cfg, tmp_path)
    frames = _frames(14, (2, 24, 40, 3))
    expect = tclip.clipiqa_metric(tmp_path, device="cpu")(frames)
    for name in ("transformers", "cv2", "regex"):
        monkeypatch.setitem(sys.modules, name, None)
    assert tclip.clipiqa_metric(tmp_path, device="cpu")(frames) == expect


def test_eval_cli_scores_clipiqa_without_gt_dir(tmp_path, monkeypatch):
    """``python -m dove_tpu_torch.eval_metrics --metrics clipiqa`` with no
    --gt_dir on two PNG folders: the JAX CLI's JSON schema and its scores
    (the same 8-bit frames and checkpoint) within 1e-5."""
    import os
    import subprocess
    from pathlib import Path

    from dove_tpu_torch import eval_metrics
    from dove_tpu_torch.io import video as tvideo

    repo = Path(__file__).resolve().parents[1]
    ckpt = tmp_path / "clip"
    vocab = clip_tokenizer.write_bpe_files(ckpt, WORDS)
    cfg = dataclasses.replace(TINY, vocab_size=vocab)
    _hf_snapshot(_noisy(jclip.init_clip_params(jax.random.PRNGKey(15), cfg), 16), cfg, ckpt)
    pred = tmp_path / "pred"
    for i, name in enumerate(("s0", "s1")):
        tvideo.save_frames_as_png(_frames(17 + i, (2, 24, 40, 3)), pred / name)
    common = ["--pred_dir", str(pred), "--metrics", "clipiqa"]
    env = {**os.environ, "DOVE_CLIP_WEIGHTS": str(ckpt)}
    res = subprocess.run(
        [sys.executable, str(repo / "scripts" / "eval_metrics.py"), *common,
         "--output", str(tmp_path / "ref.json")],
        cwd=repo, env=env, capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-3000:]
    monkeypatch.setenv("DOVE_CLIP_WEIGHTS", str(ckpt))
    eval_metrics.main(common + ["--output", str(tmp_path / "ours.json"), "--device", "cpu"])
    ref = json.loads((tmp_path / "ref.json").read_text())
    ours = json.loads((tmp_path / "ours.json").read_text())
    assert ours.keys() == ref.keys() == {"per_sample", "average", "count",
                                         "per_sample_names"}
    assert ours["count"] == ref["count"] == 2
    assert ours["per_sample_names"] == ref["per_sample_names"] == ["s0", "s1"]
    assert abs(ours["average"]["clipiqa"] - ref["average"]["clipiqa"]) <= SCORE_ATOL
    for a, b in zip(ours["per_sample"]["clipiqa"], ref["per_sample"]["clipiqa"], strict=True):
        assert abs(a - b) <= SCORE_ATOL
