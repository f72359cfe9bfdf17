"""The port's T5 encoder and prompt path against dove_tpu's (CPU).

At ``t5_tiny()`` on seeded ids: the JAX package's seeded tree carried by
``weights.from_jax_t5`` encodes as ``t5_encode`` does, masked and unmasked,
within 1e-5 of the output's largest value in fp32; the bias buckets equal
JAX's at 226 tokens; ``convert_t5`` reads an HF ``T5EncoderModel`` state
dict under both key spellings as JAX's converter does. ``PromptEncoder``
(bf16, as in both packages) on a model folder the test writes (a word-level
``tokenizer.json``, ``text_encoder/`` as two safetensors shards with an
index, and ``config.json``) gives JAX's embedding within 2e-2 of its
largest value (bf16 rounds differently in XLA and in torch), and
``python -m dove_tpu_torch.encode_prompts`` writes the files that
``scripts/encode_prompts.py`` writes, under the same names and keys, within
the same bar.
"""

from __future__ import annotations

import dataclasses
import hashlib
import importlib
import json
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dove_tpu.models import t5 as jt5
from dove_tpu_torch import safetensors_io
from dove_tpu_torch import weights as tweights
from dove_tpu_torch.models import t5 as tt5
from torch_threads import two_torch_threads  # noqa: F401 (autouse)

REPO = Path(__file__).resolve().parents[1]
FP32_REL = 1e-5
BF16_REL = 2e-2
WORDS = ["a", "cat", "dog", "runs", "in", "the", "snow", "red", "car", "city"]


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / (np.abs(b).max() + 1e-12))


@pytest.fixture(scope="module")
def jparams():
    return jax.tree.map(np.asarray, jt5.init_t5_params(jax.random.PRNGKey(0), jt5.t5_tiny()))


def _port(params, dtype=torch.float32) -> tt5.T5Encoder:
    enc = tt5.T5Encoder(tt5.t5_tiny(), dtype)
    enc.load_state_dict(tweights.from_jax_t5(params))
    return enc.eval()


def hf_state_dict(params, legacy: bool = False) -> dict[str, np.ndarray]:
    """The JAX tree in HF ``T5EncoderModel``'s layout; ``legacy`` spells
    the keys the other way (``encoder.embed_tokens``, ``block.i``)."""
    out = {("encoder.embed_tokens.weight" if legacy else "shared.weight"):
           np.asarray(params["embed"]["weight"], np.float32)}
    pre = "" if legacy else "encoder."
    out[f"{pre}block.0.layer.0.SelfAttention.relative_attention_bias.weight"] = (
        np.asarray(params["rel_emb"]["weight"], np.float32))
    out[f"{pre}final_layer_norm.weight"] = np.asarray(params["final_ln"]["weight"], np.float32)
    for i, blk in enumerate(params["blocks"]):
        b = f"{pre}block.{i}"
        out[f"{b}.layer.0.layer_norm.weight"] = np.asarray(blk["ln0"]["weight"], np.float32)
        out[f"{b}.layer.1.layer_norm.weight"] = np.asarray(blk["ln1"]["weight"], np.float32)
        for n in ("q", "k", "v", "o"):
            out[f"{b}.layer.0.SelfAttention.{n}.weight"] = np.ascontiguousarray(
                np.asarray(blk["attn"][n]["kernel"], np.float32).T)
        for n in ("wi_0", "wi_1", "wo"):
            out[f"{b}.layer.1.DenseReluDense.{n}.weight"] = np.ascontiguousarray(
                np.asarray(blk["ffn"][n]["kernel"], np.float32).T)
    return out


def write_t5_folder(root: Path, params, cfg=None, words=WORDS) -> Path:
    """A model folder with ``tokenizer/`` (word level, T5's </s> appended)
    and ``text_encoder/`` (two safetensors shards, their index and the HF
    config)."""
    from tokenizers import Tokenizer, models, pre_tokenizers, processors

    cfg = cfg or jt5.t5_tiny()
    vocab = {"<pad>": 0, "</s>": 1, "<unk>": 2}
    vocab.update({w: i + 3 for i, w in enumerate(words)})
    tok = Tokenizer(models.WordLevel(vocab, unk_token="<unk>"))
    tok.pre_tokenizer = pre_tokenizers.Whitespace()
    tok.post_processor = processors.TemplateProcessing(single="$A </s>",
                                                       special_tokens=[("</s>", 1)])
    (root / "tokenizer").mkdir(parents=True)
    tok.save(str(root / "tokenizer" / "tokenizer.json"))
    (root / "tokenizer" / "tokenizer_config.json").write_text(json.dumps(
        {"tokenizer_class": "PreTrainedTokenizerFast", "pad_token": "<pad>",
         "eos_token": "</s>", "unk_token": "<unk>", "model_max_length": 512}))
    te = root / "text_encoder"
    te.mkdir()
    sd = hf_state_dict(params)
    keys = sorted(sd)
    shards = {"model-00001-of-00002.safetensors": keys[: len(keys) // 2],
              "model-00002-of-00002.safetensors": keys[len(keys) // 2:]}
    for name, ks in shards.items():
        safetensors_io.save_file({k: sd[k] for k in ks}, te / name)
    (te / "model.safetensors.index.json").write_text(json.dumps(
        {"metadata": {}, "weight_map": {k: n for n, ks in shards.items() for k in ks}}))
    (te / "config.json").write_text(json.dumps(dataclasses.asdict(cfg)))
    return root


def _ids(seed=1, shape=(2, 40)):
    return np.random.default_rng(seed).integers(0, 128, shape)


@pytest.mark.parametrize("masked", [False, True])
def test_t5_encode_matches_jax(jparams, masked):
    ids = _ids()
    mask = None
    if masked:
        mask = np.ones_like(ids)
        mask[1, 25:] = 0
    ref = jt5.t5_encode(jparams, jt5.t5_tiny(), jnp.asarray(ids, jnp.int32),
                        None if mask is None else jnp.asarray(mask))
    with torch.no_grad():
        ours = _port(jparams)(torch.from_numpy(ids),
                              None if mask is None else torch.from_numpy(mask))
    assert ours.dtype == torch.float32 and ours.shape == (2, 40, 32)
    assert _rel(ours.numpy(), ref) < FP32_REL
    if masked:
        assert float(ours[1, 25:].abs().max()) == 0.0


def test_position_buckets_equal_jax():
    cfg = jt5.t5_xxl()
    ctx, mem = np.arange(226)[:, None], np.arange(226)[None, :]
    ref = jt5._relative_position_bucket(mem - ctx, cfg.relative_attention_num_buckets,
                                        cfg.relative_attention_max_distance)
    np.testing.assert_array_equal(tt5.position_buckets(tt5.t5_xxl(), 226), ref)


@pytest.mark.parametrize("legacy", [False, True])
def test_convert_t5_reads_both_hf_spellings(jparams, legacy):
    sd = hf_state_dict(jparams, legacy)
    cfg = jt5.t5_tiny()
    jtree = jt5.convert_t5(sd, cfg, jnp.float32)
    ids = _ids(2, (1, 17))
    ref = jt5.t5_encode(jtree, cfg, jnp.asarray(ids, jnp.int32))
    ours = tt5.convert_t5(sd, tt5.t5_tiny(), torch.float32)
    assert ours.embed.dtype == torch.float32 and ours.rel_emb.dtype == torch.float32
    with torch.no_grad():
        assert _rel(ours(torch.from_numpy(ids)).numpy(), ref) < FP32_REL
    bf16 = tt5.convert_t5(sd, tt5.t5_tiny())
    assert bf16.embed.dtype == torch.bfloat16 and bf16.blocks[0].ln0.dtype == torch.float32


def test_hf_state_dict_round_trips(jparams):
    """``hf_state_dict`` writes the names ``convert_t5`` (and JAX's
    converter) read: the same encoder back."""
    ours = _port(jparams)
    sd = tt5.hf_state_dict(ours)
    assert set(sd) == set(hf_state_dict(jparams))
    back = tt5.convert_t5(sd, tt5.t5_tiny(), torch.float32)
    jtree = jt5.convert_t5({k: v.numpy() for k, v in sd.items()}, jt5.t5_tiny(), jnp.float32)
    ids = _ids(3, (1, 12))
    with torch.no_grad():
        assert torch.equal(back(torch.from_numpy(ids)), ours(torch.from_numpy(ids)))
        assert _rel(back(torch.from_numpy(ids)).numpy(),
                    jt5.t5_encode(jtree, jt5.t5_tiny(), jnp.asarray(ids, jnp.int32))) < FP32_REL


@pytest.fixture(scope="module")
def model_dir(tmp_path_factory, jparams):
    return write_t5_folder(tmp_path_factory.mktemp("t5"), jparams)


def test_prompt_encoder_matches_jax(model_dir):
    ours = tt5.PromptEncoder(model_dir, max_length=12, device="cpu")
    ref = jt5.PromptEncoder(model_dir, max_length=12)
    assert ours.cfg == tt5.t5_tiny()
    assert ours.model.embed.dtype == torch.bfloat16
    for prompt in ("a red cat runs in the snow", "", "zebra city"):
        o, r = ours(prompt), ref(prompt)
        assert o.dtype == np.float32 and o.shape == r.shape == (12, 32)
        assert _rel(o, r) < BF16_REL, prompt
    masked = tt5.PromptEncoder(model_dir, max_length=12, device="cpu",
                               use_attention_mask=True)("a cat")
    assert float(np.abs(masked[3:]).max()) == 0.0  # "a cat </s>" then pads
    assert float(np.abs(ours("a cat")[3:]).max()) > 0  # unmasked: pads embed


def test_encode_prompts_matches_the_jax_script(model_dir, tmp_path, monkeypatch):
    from dove_tpu_torch import encode_prompts

    prompts = tmp_path / "prompts.txt"
    prompts.write_text("a cat\nthe red car\na cat\n\n")
    flags = ["--model_path", str(model_dir), "--prompts_file", str(prompts),
             "--max_length", "10"]
    encode_prompts.main(flags + ["--output_dir", str(tmp_path / "ours"), "--device", "cpu"])
    sys.path.insert(0, str(REPO / "scripts"))
    try:
        script = importlib.import_module("encode_prompts")
    finally:
        sys.path.remove(str(REPO / "scripts"))
    monkeypatch.setattr(sys, "argv", ["encode_prompts.py", *flags,
                                      "--output_dir", str(tmp_path / "ref")])
    script.main()
    names = sorted(p.name for p in (tmp_path / "ref").iterdir())
    assert names == sorted(p.name for p in (tmp_path / "ours").iterdir())
    want = {hashlib.sha256(p.encode()).hexdigest() + ".safetensors"
            for p in ("", "a cat", "the red car")}
    assert set(names) == want
    for name in names:
        ours = safetensors_io.load_file(tmp_path / "ours" / name)
        ref = safetensors_io.load_file(tmp_path / "ref" / name)
        assert set(ours) == set(ref) == {"prompt_embedding"}
        o, r = ours["prompt_embedding"].numpy(), ref["prompt_embedding"].numpy()
        assert o.dtype == r.dtype == np.float32 and o.shape == r.shape == (10, 32)
        assert _rel(o, r) < BF16_REL, name


def test_seeded_t5_is_the_fp32_model_rounded():
    """``init_t5`` draws in fp32 whatever the dtype, so the bf16 encoder is
    the fp32 one rounded (what chip_smoke.py holds T5-XXL to)."""
    cfg = dataclasses.replace(tt5.t5_tiny(), num_layers=1)
    f32, b16 = tt5.init_t5(cfg, seed=3), tt5.init_t5(cfg, seed=3, dtype=torch.bfloat16)
    for (n, a), (_, b) in zip(f32.named_parameters(), b16.named_parameters()):
        assert torch.equal(a.to(b.dtype), b), n
    ids = torch.from_numpy(_ids(4, (1, 20)))
    with torch.no_grad():
        assert _rel(b16(ids).float().numpy(), f32(ids).numpy()) < BF16_REL
