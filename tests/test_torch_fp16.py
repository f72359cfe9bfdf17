"""fp16 in the PyTorch port against dove_tpu in fp16, on the CPU.

Both packages run fp16 here; the JAX package's Pallas kernels are generic in
the model dtype (P cast to v's dtype, dS to k's, the convs' ``out_dtype``),
and so are the port's kernels and their plain versions. Tiny widths, the
1.5-5B structure (``tiny_test``) and the 2B's (tests/test_parity_golden.py's
config), perturbed weights carried across by ``from_jax_params``, inputs
drawn with numpy. fp16 rounds differently in the two frameworks' glue, so
each bar is in dB against JAX's fp16 result, and the port's distance from
the fp32 result is held to JAX's own:

* the DiT forward (bounded and online): PSNR >= 70 dB against JAX in fp16
  (measured 78.5-82.8 dB), and no more than 1 dB further from the fp32
  forward than JAX's fp16 forward is;
* a staged clip and an ``int8-dit`` clip in uint8: PSNR >= 50 dB against
  JAX in fp16 (measured 56.6-60.1 dB), at most 4 LSB apart (measured 3),
  and within 1 dB of JAX's own distance from its fp32 clip;
* one stage-1 loss and its LoRA gradients: the loss within 1e-4 relative of
  JAX's fp16 loss (measured <= 5e-5), each gradient within 3e-2 of the leaf's
  largest fp32 gradient of JAX's fp16 gradient (measured <= 9.7e-3), and no
  further from the fp32 gradient than twice JAX's own distance (or 5e-3);
* K4's fp16 epilogue equal to the Pallas kernel's (interpret mode), K5's
  fp16 output within its 2e-5 bar, the quantizer's pass equal on fp16 input,
  and the kernels' dtype checks: fp16 and bf16 reach a kernel form, any
  other dtype raises.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dove_tpu.ops.pallas.conv3d_int8 as jconv
from dove_tpu import config as jcfg
from dove_tpu.models import dit as jdit
from dove_tpu.models import vae as jvae
from dove_tpu.ops.scheduler import Schedule as JSchedule
from dove_tpu.pipeline import DovePipeline as JPipeline
from dove_tpu.train import lora as jlora
from dove_tpu.train import losses as jlosses
from dove_tpu_torch import config as tcfg
from dove_tpu_torch import weights as tweights
from dove_tpu_torch.ops import conv3d_int8 as tconv
from dove_tpu_torch.ops import flash_attention as fa
from dove_tpu_torch.ops.scheduler import Schedule
from dove_tpu_torch.pipeline import DovePipeline
from dove_tpu_torch.train import lora as tlora
from dove_tpu_torch.train import losses as tlosses
from test_torch_dit import golden_config
from test_torch_dit_2b import SCALE, _jax_config, _lora_tree, _perturbed

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

DIT_PSNR_DB = 70.0
CLIP_PSNR_DB = 50.0
CLIP_MAX_LSB = 4
FP32_DISTANCE_DB = 1.0  # how much further from fp32 than JAX's fp16 the port may be
LOSS_RTOL = 1e-4
GRAD_TOL = 3e-2


def psnr_db(ours: np.ndarray, ref: np.ndarray) -> float:
    ours, ref = np.asarray(ours, np.float64), np.asarray(ref, np.float64)
    span = float(ref.max() - ref.min()) or 1.0
    mse = float(np.mean((ours - ref) ** 2))
    return 200.0 if mse == 0 else 10.0 * np.log10(span**2 / mse)


FAMILIES = {"5b": (jcfg.tiny_test, tcfg.tiny_test),
            "2b": (_jax_config, lambda: golden_config("2b"))}
DTYPES = {"fp32": (jnp.float32, torch.float32), "fp16": (jnp.float16, torch.float16)}


@pytest.fixture(scope="module")
def families():
    """family -> (JAX config, port config, DiT tree, VAE tree)."""
    out = {}
    for name, (jc, tc) in FAMILIES.items():
        cfg_j = jc()
        dit = _perturbed(jdit.init_dit_params(jax.random.PRNGKey(0), cfg_j.dit), 1)
        vae = jax.tree.map(np.asarray,
                           jvae.init_vae_params(jax.random.PRNGKey(1), cfg_j.vae))
        out[name] = (cfg_j, tc(), dit, vae)
    return out


def _cast(tree, dtype):
    return jax.tree.map(lambda x: jnp.asarray(x, dtype), tree)


@pytest.mark.parametrize("bounded", [True, False])
@pytest.mark.parametrize("family", list(FAMILIES))
def test_fp16_dit_forward_matches_jax(families, family, bounded):
    cfg_j, cfg_t, dit_tree, vae_tree = families[family]
    rng = np.random.default_rng(2)
    latent = rng.standard_normal((1, 4, 8, 8, 8)).astype(np.float32)
    text = rng.standard_normal((1, 7, 32)).astype(np.float32)
    t = np.array([399], np.int32)
    backend = "flash" if bounded else None
    res = {}
    for name, (jt, tt) in DTYPES.items():
        ref = jdit.dit_forward(
            _cast(dit_tree, jt), cfg_j.dit, jnp.asarray(latent, jt),
            jnp.asarray(text, jt), jnp.asarray(t), bounded_logits=bounded,
            attention_backend=backend)
        dit, _ = tweights.from_jax_params(cfg_t, dit_tree, vae_tree, dtype=tt)
        with torch.no_grad():
            ours = dit(torch.from_numpy(latent).to(tt), torch.from_numpy(text).to(tt),
                       torch.from_numpy(t), bounded_logits=bounded,
                       attention_backend=backend)
        assert ours.dtype == tt
        res[name] = (np.asarray(ref, np.float32), ours.float().numpy())
    ref16, ours16 = res["fp16"]
    ref32 = res["fp32"][0]
    assert psnr_db(ours16, ref16) >= DIT_PSNR_DB
    assert psnr_db(ours16, ref32) >= psnr_db(ref16, ref32) - FP32_DISTANCE_DB


@pytest.mark.parametrize("quantize", [None, "int8-dit"])
@pytest.mark.parametrize("family", list(FAMILIES))
def test_fp16_staged_clip_matches_jax(families, family, quantize):
    """The staged path on 9 frames of 16 x 16 (uint8 out, posterior mean)."""
    cfg_j, cfg_t, dit_tree, vae_tree = families[family]
    prompt = np.random.default_rng(0).standard_normal((7, 32)).astype(np.float32)
    frames = np.random.default_rng(3).uniform(0, 1, (9, 16, 16, 3)).astype(np.float32)
    res = {}
    for name, (jt, tt) in DTYPES.items():
        jp = JPipeline(
            config=cfg_j, dit_params=_cast(dit_tree, jt), vae_params=_cast(vae_tree, jt),
            prompt_embedding=jnp.asarray(prompt, jt), dtype=jt, sample_posterior=False,
            donate_weights=False, output_uint8=True, vae_tiling=True, quantize=quantize)
        ref = jp.process_frames(frames, seed=0)
        if name == "fp32":
            res[name] = (ref, None)
            continue
        dit, vae = tweights.from_jax_params(cfg_t, dit_tree, vae_tree, dtype=tt)
        tp = DovePipeline(
            config=cfg_t, dit=dit, vae=vae,
            prompt_embedding=torch.from_numpy(prompt).to(tt), dtype=tt, device="cpu",
            sample_posterior=False, output_uint8=True, vae_tiling=True,
            quantize=quantize)
        res[name] = (ref, tp.process_frames(frames, seed=0))
    ref16, ours16 = res["fp16"]
    ref32 = res["fp32"][0]
    assert ours16.shape == ref16.shape == (9, 64, 64, 3) and ours16.dtype == np.uint8
    assert np.abs(ours16.astype(int) - ref16.astype(int)).max() <= CLIP_MAX_LSB
    assert psnr_db(ours16, ref16) >= CLIP_PSNR_DB
    assert psnr_db(ours16, ref32) >= psnr_db(ref16, ref32) - FP32_DISTANCE_DB


@pytest.mark.parametrize("family", list(FAMILIES))
def test_fp16_stage1_loss_and_lora_grads_match_jax(families, family):
    """The stage-1 loss through the flash backend (K1-lse, K3a, K3b's plain
    versions here) with the DiT and the batch in fp16 and the LoRA tree in
    fp32, as the trainer keeps them, on both sides."""
    cfg_j, cfg_t, dit_tree, vae_tree = families[family]
    tree = _lora_tree(cfg_j.dit, seed=3)
    rng = np.random.default_rng(4)
    batch = {"lq_latent": rng.standard_normal((2, 3, 8, 6, 8)).astype(np.float32),
             "hq_latent": rng.standard_normal((2, 3, 8, 6, 8)).astype(np.float32),
             "prompt_embeds": rng.standard_normal((2, 7, 32)).astype(np.float32)}
    res = {}
    for name, (jt, tt) in DTYPES.items():
        params_j = _cast(dit_tree, jt)
        sched_j = JSchedule.create(cfg_j.scheduler)
        batch_j = _cast(batch, jt)

        def loss_j(lora, params_j=params_j, sched_j=sched_j, batch_j=batch_j):
            return jlosses.stage1_loss(cfg_j, sched_j, jlora.apply_lora(params_j, lora, SCALE),
                                       batch_j, None, attention_backend="flash")

        (ref_loss, _), ref_grads = jax.jit(jax.value_and_grad(loss_j, has_aux=True))(
            _cast(tree, jnp.float32))
        ref = (float(ref_loss), {(t, ab): np.asarray(ref_grads[t][ab], np.float32)
                                 for t in tlora.TARGETS for ab in "AB"})
        if name == "fp32":
            res[name] = (ref, None)
            continue
        dit, _ = tweights.from_jax_params(cfg_t, dit_tree, vae_tree, dtype=tt)
        lora_t = tweights.from_jax_lora(tree)
        loss, _ = tlosses.stage1_loss(
            cfg_t, Schedule.create(cfg_t.scheduler), dit,
            {k: torch.from_numpy(v).to(tt) for k, v in batch.items()},
            attention_backend="flash", lora=lora_t, lora_scale=SCALE)
        loss.backward()
        ours = (float(loss.detach()), {(t, ab): lora_t[t][ab].grad.float().numpy()
                                       for t in tlora.TARGETS for ab in "AB"})
        res[name] = (ref, ours)
    (ref_loss16, ref_g16), (loss16, g16) = res["fp16"]
    _, ref_g32 = res["fp32"][0]
    np.testing.assert_allclose(loss16, ref_loss16, rtol=LOSS_RTOL)
    for key, g32 in ref_g32.items():
        top = float(np.abs(g32).max())
        assert top > 0
        assert np.abs(g16[key] - ref_g16[key]).max() / top <= GRAD_TOL, key
        own = np.abs(ref_g16[key] - g32).max() / top
        assert np.abs(g16[key] - g32).max() / top <= max(2 * own, 5e-3), key


# ---------------------------------------------------------------------------
# The kernels' fp16 forms: plain versions against the Pallas kernels, and
# the wrappers' dtype checks
# ---------------------------------------------------------------------------

@pytest.fixture()
def _interpret(monkeypatch):
    monkeypatch.setattr(jconv.pl, "pallas_call",
                        functools.partial(jconv.pl.pallas_call, interpret=True))
    jconv.conv3d_w8a8.clear_cache()
    jconv.conv3d_bf16.clear_cache()


def test_k4_fp16_epilogue_equals_pallas(_interpret):
    """K4 rounds float(acc) * scale once to fp16, as the Pallas kernel does
    with out_dtype float16; the plain version is what the CUDA kernel is held
    to bit for bit on the card."""
    rng = np.random.default_rng(11)
    x_q = rng.integers(-127, 128, (4, 7, 20, 128)).astype(np.int8)
    w_q = rng.integers(-127, 128, (3, 3, 3, 128, 128)).astype(np.int8)
    sk = (rng.random(128, np.float32) * 0.02).astype(np.float32)
    ref = jconv.conv3d_w8a8(jnp.asarray(x_q), jnp.asarray(w_q), jnp.float32(0.013),
                            jnp.asarray(sk), out_dtype=jnp.float16)
    ours = tconv.conv3d_w8a8(torch.from_numpy(x_q), torch.from_numpy(w_q),
                             torch.tensor(np.float32(0.013)), torch.from_numpy(sk),
                             out_dtype=torch.float16)
    assert ours.dtype == torch.float16 and ref.dtype == jnp.float16
    np.testing.assert_array_equal(ours.numpy(), np.asarray(ref))
    f32 = tconv.conv3d_w8a8(torch.from_numpy(x_q), torch.from_numpy(w_q),
                            torch.tensor(np.float32(0.013)), torch.from_numpy(sk),
                            out_dtype=torch.float32)
    assert torch.equal(ours, f32.to(torch.float16))  # one rounding


def test_k5_fp16_out_matches_pallas(_interpret):
    """K5 keeps bf16 operands in an fp16 VAE (the JAX package rounds x and w
    to bf16) and rounds its fp32 sums once to fp16: within K5's 2e-5 of the
    largest output, plus the fp16 rounding of either side."""
    rng = np.random.default_rng(12)
    x = rng.normal(0, 1, (4, 7, 20, 128)).astype(np.float16)
    w = rng.normal(0, 0.03, (3, 3, 3, 128, 128)).astype(np.float16)
    ref = np.asarray(jconv.conv3d_bf16(jnp.asarray(x), jnp.asarray(w),
                                       out_dtype=jnp.float16), np.float32)
    ours = tconv.conv3d_bf16(torch.from_numpy(x), torch.from_numpy(w),
                             out_dtype=torch.float16)
    assert ours.dtype == torch.float16
    top = float(np.abs(ref).max())
    np.testing.assert_allclose(ours.float().numpy(), ref,
                               atol=2e-5 * top + 2.0 ** -11 * top, rtol=0)


def test_quantize_pack_plain_takes_fp16():
    """The quantizer's pass on fp16 input gives the codes of the same values
    in fp32 (the kernel's route reads fp16 and computes in fp32)."""
    rng = np.random.default_rng(13)
    x = torch.from_numpy(rng.normal(0, 1, (1, 8, 3, 5, 6)).astype(np.float16))
    s, m = torch.tensor(0.02), torch.tensor(0.1)
    got = tconv.quantize_pack(x, s, m)
    want = tconv.quantize_pack(x.float(), s, m)
    assert got.dtype == torch.int8 and torch.equal(got, want)


def test_kernel_wrappers_take_bf16_and_fp16_only():
    """_check_cuda_inputs (run before any launch) takes q, k, v in one model
    type, bf16 or fp16 (int8 q and k for K2), and raises on anything else;
    the conv's epilogue and the quantizer's pass name their fp16 code."""
    for dtype in (torch.bfloat16, torch.float16):
        q = torch.zeros(1, 2, 8, 64, dtype=dtype)
        assert fa._check_cuda_inputs(q, q, q) == (1, 2, 8, 8, 64)
        q8 = torch.zeros(1, 2, 8, 64, dtype=torch.int8)
        assert fa._check_cuda_inputs(q8, q8, q, qk8=True) == (1, 2, 8, 8, 64)
    f32 = torch.zeros(1, 2, 8, 64)
    with pytest.raises(ValueError, match="bf16 or fp16"):
        fa._check_cuda_inputs(f32, f32, f32)
    h, b = f32.half(), f32.bfloat16()
    with pytest.raises(ValueError, match="takes torch.float16 q"):
        fa._check_cuda_inputs(b, h, h)
    assert set(fa.KERNEL_DTYPES) == {torch.bfloat16, torch.float16}
    assert tconv.OUT_TYPES[torch.float16] == 2 == tconv.QUANT_INPUT_TYPES[torch.float16]
