"""Mesh serving of the PyTorch port (``dove_tpu_torch/parallel``, the
pipeline's mesh routes) against the JAX package's, on the CPU.

The port runs one process per device: each module-scoped run spawns 2 or 4
gloo ranks (``tests/torch_parallel_ranks.py``, which imports no JAX) that
build the tiny_test() models from the JAX package's seeded weights and run
every case; the JAX side runs here, on the 8-device virtual CPU mesh of
tests/conftest.py. The bars are the JAX package's own (tests/test_tp.py):

  * the tensor- and sequence-parallel DiT within rel 1e-5 of one device and
    of JAX's ``make_tp_dit``; int8 TP and SP within 3e-2 of sequential int8;
  * window sharding and chunk-parallel staged clips equal the port's world
    size 1 bit for bit (chunks with the posterior sampled and noise added at
    noise_step: each rank draws what one process draws);
  * data-parallel fused clips within 1e-4 of world size 1 (the noise is the
    same; oneDNN's convs and MKL's GEMMs round differently for a batch of 1
    than for 2, ~1e-5 here);
  * tensor-parallel staged clips within one uint8 step of JAX's meshed clip;
  * the inference CLI as two processes: rank 0 writes what one process does,
    within one uint8 step.
"""

from __future__ import annotations

import os
import subprocess
import sys
from pathlib import Path

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parallel_ranks as ranks
from dove_tpu import config as jcfg
from dove_tpu.models import dit as jdit
from dove_tpu.models import vae as jvae
from dove_tpu.ops.quant import quantize_dit as jquantize_dit
from dove_tpu.parallel import mesh as jmesh
from dove_tpu.parallel import tp as jtp
from dove_tpu.pipeline import DovePipeline as JPipeline
from dove_tpu_torch import config as tcfg
from dove_tpu_torch import inference
from dove_tpu_torch import weights as tweights
from dove_tpu_torch.io import video as tvideo
from dove_tpu_torch.ops.quant import quantize_dit
from dove_tpu_torch.parallel import mesh as tmesh
from dove_tpu_torch.parallel import tp as ttp

CAP = dict(dec_window_cap=(3, 3))  # a 2x2 decode plan on the 4x4 latent
LONG = dict(chunk_len=9, overlap_t=4)
SAMPLED = dict(sample_posterior=True, noise_step=100)
DIT_CASES = {
    2: {"tp2": ((1, 2), 2, None)},
    4: {"tp4": ((1, 4), 2, None), "sp22": ((2, 2), 1, None),
        "int8_tp4": ((1, 4), 2, "int8"), "int8_sp22": ((2, 2), 1, "int8")},
}
CLIP_CASES = {
    2: {"win_dec": dict(mesh=(2, 1), flags=CAP),
        "win_enc": dict(mesh=(2, 1), budget=(2, (3, 3), (3, 3))),
        "chunks": dict(mesh=(2, 1), long=True, flags={**CAP, **SAMPLED}, kw=LONG),
        "fused": dict(mesh=(2, 1), long=True,
                      flags=dict(vae_tiling=False, output_uint8=False, **SAMPLED),
                      kw=dict(LONG, tile_batch=2)),
        "tp12": dict(mesh=(1, 2), flags=CAP, ws1=False)},
    4: {"win_dec4": dict(mesh=(4, 1), flags=CAP),
        "tp22": dict(mesh=(2, 2), flags=CAP, ws1=False),
        "chunks_tp22": dict(mesh=(2, 2), long=True, flags=CAP, kw=LONG)},
}


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / (np.abs(b).max() + 1e-9))


@pytest.fixture(scope="module")
def jax_models():
    cfg = jcfg.tiny_test()
    dit = jdit.init_dit_params(jax.random.PRNGKey(0), cfg.dit)
    vae = jvae.init_vae_params(jax.random.PRNGKey(1), cfg.vae)
    prompt = np.zeros((cfg.dit.max_text_seq_length, cfg.dit.text_embed_dim), np.float32)
    return cfg, dit, vae, prompt


@pytest.fixture(scope="module")
def inputs(jax_models):
    cfg, dit, vae, prompt = jax_models
    B = 2
    return dict(
        dit=jax.tree.map(np.asarray, dit), vae=jax.tree.map(np.asarray, vae),
        prompt=prompt,
        z=np.asarray(jax.random.normal(jax.random.PRNGKey(1),
                                       (B, 2, cfg.dit.in_channels, 4, 8), jnp.float32)),
        text=np.asarray(jax.random.normal(
            jax.random.PRNGKey(2),
            (B, cfg.dit.max_text_seq_length, cfg.dit.text_embed_dim), jnp.float32)),
        t=np.full((B,), 399, np.int64),
        frames=np.random.default_rng(3).random((9, 8, 8, 3)).astype(np.float32),
        long_frames=np.random.default_rng(4).random((14, 8, 8, 3)).astype(np.float32),
        dit_cases=DIT_CASES, clip_cases=CLIP_CASES)


@pytest.fixture(scope="module")
def served(inputs, tmp_path_factory):
    """{case: result} of the 2-rank and the 4-rank runs."""
    work = tmp_path_factory.mktemp("served")
    ranks.dump(inputs, work / "in.pkl")
    out = {}
    for world in (2, 4):
        ranks.spawn(ranks.serve, world, work, str(work / "in.pkl"),
                    str(work / f"out{world}.pkl"))
        out.update(ranks.load(work / f"out{world}.pkl"))
    return out


def _jax_dit(jax_models, inputs, batch, quantize=False, mesh_shape=None):
    cfg, params, _, _ = jax_models
    if quantize:
        params = jquantize_dit(params, donate=False)
    z, text, t = (jnp.asarray(inputs[k][:batch]) for k in ("z", "text", "t"))
    t = t.astype(jnp.int32)
    if mesh_shape is None:
        return np.asarray(jdit.dit_forward(params, cfg.dit, z, text, t))
    mesh = jmesh.make_mesh(*mesh_shape)
    sharded = jtp.shard_dit_tp(params, mesh, donate=False)
    return np.asarray(jax.jit(jtp.make_tp_dit(mesh, cfg.dit))(sharded, z, text, t))


@pytest.mark.parametrize("case", ["tp2", "tp4", "sp22"])
def test_tp_and_sp_dit_match_jax(served, jax_models, inputs, case):
    """TP at 2 and 4, and SP at B = 1 on 2x2, within rel 1e-5 of JAX's one
    device and of its meshed ``make_tp_dit`` (tests/test_tp.py:53-99)."""
    mesh_shape, batch, _ = {**DIT_CASES[2], **DIT_CASES[4]}[case]
    ours = served[case]
    ref = _jax_dit(jax_models, inputs, batch)
    assert ours.shape == ref.shape
    assert _rel(ours, ref) < 1e-5
    assert _rel(ours, _jax_dit(jax_models, inputs, batch, mesh_shape=mesh_shape)) < 1e-5


@pytest.mark.parametrize("case", ["int8_tp4", "int8_sp22"])
def test_int8_tp_and_sp_close_to_sequential_int8(served, jax_models, inputs, case):
    """int8 under TP takes each row-parallel input's activation scale over
    its shard (under SP over its token slice too): within 3e-2 of the
    sequential int8 DiT of both packages (tests/test_tp.py:110-140)."""
    _, batch, _ = DIT_CASES[4][case]
    ours = served[case]
    assert _rel(ours, _jax_dit(jax_models, inputs, batch, quantize=True)) < 3e-2
    cfg = tcfg.tiny_test()
    dit, _ = tweights.from_jax_params(cfg, inputs["dit"], inputs["vae"])
    quantize_dit(dit)
    with torch.no_grad():
        seq = dit(*(torch.tensor(inputs[k][:batch]) for k in ("z", "text", "t")))
    assert _rel(ours, seq.numpy()) < 3e-2


@pytest.mark.parametrize("case", ["win_dec", "win_enc", "win_dec4"])
def test_window_sharding_is_bit_exact(served, case):
    """The staged path's encode / decode windows spread over 2 or 4 ranks
    (4 ranks for a 4-window plan pads nothing, 2 ranks take two each)."""
    ours, ref = served[case]
    assert ours.dtype == np.uint8 and ours.shape == (9, 32, 32, 3)
    np.testing.assert_array_equal(ours, ref)


def test_chunk_parallel_staged_equals_world_size_1(served):
    """Temporal chunks over the "data" rows, with the posterior sampled and
    noise at noise_step: each rank passes over the others' draws."""
    ours, ref = served["chunks"]
    assert ours.shape == (14, 32, 32, 3)
    np.testing.assert_array_equal(ours, ref)


def test_data_parallel_fused_matches_world_size_1(served):
    ours, ref = served["fused"]
    assert ours.shape == ref.shape == (14, 32, 32, 3)
    np.testing.assert_allclose(ours, ref, atol=1e-4, rtol=0)


def _jax_clip(jax_models, inputs, frames, mesh_shape=None, **kw):
    cfg, dit, vae, prompt = jax_models
    pipe = JPipeline(
        config=cfg, dit_params=dit, vae_params=vae, prompt_embedding=jnp.asarray(prompt),
        dtype=jnp.float32, donate_input=False, sample_posterior=False,
        donate_weights=False, vae_tiling=True, output_uint8=True, **CAP)
    mesh = None if mesh_shape is None else jmesh.make_mesh(*mesh_shape)
    return pipe.process_frames(frames, mesh=mesh, **kw)


@pytest.mark.parametrize("case,mesh_shape", [("tp12", (1, 2)), ("tp22", (2, 2))])
def test_tp_staged_clip_within_one_of_jax(served, jax_models, inputs, case, mesh_shape):
    """The staged clip with the DiT over "model" (and SP over "data" at
    2x2) within one uint8 step of JAX's meshed and sequential clips."""
    ours, _ = served[case]
    for ref in (_jax_clip(jax_models, inputs, inputs["frames"], mesh_shape),
                _jax_clip(jax_models, inputs, inputs["frames"])):
        assert ours.shape == ref.shape
        assert np.abs(ours.astype(int) - ref.astype(int)).max() <= 1


def test_chunk_parallel_composes_with_tp(served, jax_models, inputs):
    """Chunks over "data" and each chunk's DiT over "model" (2x2): within
    one step of JAX's sequential clip and of the port's world size 1."""
    ours, ref = served["chunks_tp22"]
    jref = _jax_clip(jax_models, inputs, inputs["long_frames"], **LONG)
    for want in (ref, jref):
        assert ours.shape == want.shape
        assert np.abs(ours.astype(int) - want.astype(int)).max() <= 1


def test_fsdp_spec_matches_jax(jax_models):
    """The rule on every DiT and VAE leaf shape, at 2 and 4 ways."""
    _, dit, vae, _ = jax_models
    for leaf in jax.tree.leaves(dit) + jax.tree.leaves(vae):
        for n in (2, 4):
            assert tmesh.fsdp_spec(leaf.shape, "model", n) == tuple(
                jmesh.fsdp_spec(leaf, "model", n)), (leaf.shape, n)


@pytest.mark.parametrize("quantized", [False, True])
def test_tp_split_dims_match_jax(jax_models, inputs, quantized):
    """Each DiT tensor splits where JAX's ``dit_tp_specs`` splits its leaf:
    torch's [out, in] transposes JAX's [in, out], so JAX's last dim is the
    port's dim 0 and JAX's dim -2 the port's dim 1."""
    _, dit, _, _ = jax_models
    if quantized:
        dit = jquantize_dit(dit, donate=False)
    specs = jtp.dit_tp_specs(dit)
    dit_t, _ = tweights.from_jax_params(tcfg.tiny_test(), inputs["dit"], inputs["vae"])
    if quantized:
        quantize_dit(dit_t)
    names = {"to_q": "attn1.to_q", "to_k": "attn1.to_k", "to_v": "attn1.to_v",
             "to_out": "attn1.to_out.0", "net_0_proj": "ff.net.0.proj", "net_2": "ff.net.2"}
    leaves = {"kernel": "weight", "kernel_q": "weight_q", "kernel_scale": "scale",
              "bias": "bias"}
    ours = ttp.dit_tp_specs(dit_t)
    split = 0
    for group in ("attn1", "ff"):
        for layer, sub in specs["blocks"][group].items():
            if layer not in names:
                continue
            for leaf, spec in sub.items():
                jdim = spec.index("model") if "model" in spec else None
                want = None if jdim is None else (0 if jdim == len(spec) - 1 else 1)
                key = f"transformer_blocks.0.{names[layer]}.{leaves[leaf]}"
                assert ours[key] == want, key
                split += want is not None
    # nothing else splits (JAX's specs are per stacked leaf, the port's per layer)
    assert split >= 8
    assert sum(d is not None for d in ours.values()) == split * tcfg.tiny_test().dit.num_layers


def test_validate_tp_rejects_nondividing(jax_models):
    cfg = tcfg.tiny_test().dit  # 4 heads
    for validate, c in ((ttp.validate_tp, cfg), (jtp.validate_tp, jax_models[0].dit)):
        with pytest.raises(ValueError, match="tensor_parallel=3"):
            validate(c, 3)


def test_two_process_inference_cli(tmp_path):
    """``python -m dove_tpu_torch.inference --tensor_parallel 2 --is_vae_st``
    as two processes joined through the DOVE_* variables: rank 0 alone
    writes the frames, within one uint8 step of one process's."""
    (tmp_path / "in").mkdir()
    writer = cv2.VideoWriter(str(tmp_path / "in" / "clip.mp4"),
                             cv2.VideoWriter_fourcc(*"mp4v"), 8, (16, 16))
    for frame in np.random.default_rng(6).integers(0, 255, (9, 16, 16, 3), np.uint8):
        writer.write(frame)
    writer.release()
    flags = ["--input_dir", str(tmp_path / "in"), "--device", "cpu", "--preset", "tiny",
             "--dtype", "float32", "--is_vae_st", "--png_save", "--seed", "0"]
    repo = Path(__file__).resolve().parents[1]
    procs = [subprocess.Popen(
        [sys.executable, "-m", "dove_tpu_torch.inference", *flags, "--tensor_parallel", "2",
         "--output_path", str(tmp_path / "tp")], cwd=repo, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True,
        env=dict(os.environ, DOVE_COORDINATOR=f"file://{tmp_path}/rendezvous",
                 DOVE_NUM_PROCESSES="2", DOVE_PROCESS_ID=str(pid), OMP_NUM_THREADS="1",
                 PYTHONPATH=str(repo))) for pid in range(2)]
    logs = [p.communicate(timeout=240)[0] for p in procs]
    assert [p.returncode for p in procs] == [0, 0], logs[0][-2000:] + logs[1][-2000:]
    inference.main([*flags, "--output_path", str(tmp_path / "one")])
    ours = tvideo.read_image_folder(tmp_path / "tp" / "clip")
    ref = tvideo.read_image_folder(tmp_path / "one" / "clip")
    assert ours.shape == ref.shape == (9, 64, 64, 3)
    assert np.abs(ours - ref).max() <= 1.0 / 255 + 1e-6
    assert sorted(p.name for p in (tmp_path / "tp").iterdir()) == ["clip"]
