"""K1 and K2 in the PyTorch port: the plain versions against dove_tpu's kernel.

On the CPU the port's ``flash_attention`` runs its plain PyTorch version (K1's,
or K2's with ``qk_int8``); it is held to ``dove_tpu.ops.pallas.flash_attention``
run in Pallas interpret mode (as tests/test_flash_attention.py runs it), with
blocks that make the JAX side pad and mask a ragged tail. The CUDA kernels
themselves are held to their plain versions on the card by chip_smoke.py and
by the ``cuda``-marked tests in tests/test_torch_cuda.py.
"""

from __future__ import annotations

import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dove_tpu.ops.pallas import flash_attention as jfa
from dove_tpu.ops.pallas.flash_attention import flash_attention as jax_flash
from dove_tpu_torch import kernels
from dove_tpu_torch.ops import attention as tattn
from dove_tpu_torch.ops import flash_attention as fa

REPO = Path(__file__).resolve().parents[1]
ATOL = 2e-5  # fp32: the two differ only in summation order


def _qkv(S: int, seed: int, H: int = 2, D: int = 64, Skv: int | None = None):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((1, H, S, D)).astype(np.float32)
    k = rng.standard_normal((1, H, Skv or S, D)).astype(np.float32)
    v = rng.standard_normal((1, H, Skv or S, D)).astype(np.float32)
    return q, k, v


@pytest.mark.parametrize("S", [200, 640])
@pytest.mark.parametrize("bounded", [False, True])
def test_plain_matches_pallas_interpret(S, bounded):
    q, k, v = _qkv(S, seed=S + bounded)
    ref = jax_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), None, 128, 128,
                    bounded)
    fa.launches.reset()
    ours = fa.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                              torch.from_numpy(v), bounded_logits=bounded)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=ATOL, rtol=0)
    assert fa.launches.count == 0  # the CPU never launches the kernel


def test_launch_counter_records_shapes_only_when_asked():
    counter = fa.LaunchCounter()
    counter.add(torch.Size((1, 2, 3, 64)))
    assert counter.count == 1 and counter.shapes is None
    counter.shapes = []
    counter.add(torch.Size((2, 48, 994, 64)))
    counter.reset()
    counter.add(torch.Size((2, 48, 738, 64)))
    assert counter.count == 1
    assert counter.shapes == [(2, 48, 994, 64), (2, 48, 738, 64)]


def test_plain_cross_lengths_match_naive():
    """Sq != Skv (the kernel takes both); the plain version vs softmax."""
    q, k, v = _qkv(130, seed=7, Skv=300)
    qt, kt, vt = (torch.from_numpy(x) for x in (q, k, v))
    ref = tattn._naive_attention(qt, kt, vt)
    for bounded in (False, True):
        ours = fa.flash_attention_plain(qt, kt, vt, bounded_logits=bounded)
        np.testing.assert_allclose(ours.numpy(), ref.numpy(), atol=ATOL, rtol=0)


def test_unported_modes_raise():
    """K2 is inference only: no logsumexp and no backward, as in JAX; it
    needs the bounded form, as the TPU wrapper does."""
    q, k, v = (torch.from_numpy(x) for x in _qkv(16, seed=3))
    with pytest.raises(NotImplementedError):
        fa.flash_attention(q, k, v, bounded_logits=True, qk_int8=True, with_lse=True)
    with pytest.raises(NotImplementedError):
        fa.flash_attention(q.clone().requires_grad_(), k, v, bounded_logits=True,
                           qk_int8=True)
    with pytest.raises(ValueError, match="requires bounded_logits"):
        fa.flash_attention(q, k, v, qk_int8=True)
    for backend in ("flash-qk8", "plain-qk8"):
        with pytest.raises(ValueError, match="requires bounded_logits"):
            tattn.full_attention(q, k, v, backend=backend)
    with pytest.raises(ValueError):
        tattn.full_attention(q, k, v, backend="nope")


K2_FLASH = jax.jit(jax_flash, static_argnums=(3, 4, 5, 6, 7))


@pytest.mark.parametrize("sq,skv", [(226, 226), (640, 640), (130, 300)])
def test_qk8_plain_matches_pallas_interpret(sq, skv):
    """K2's plain version against the TPU kernel's qk8 form in interpret
    mode, jitted as the pipeline runs it (XLA then scales by the fp32
    reciprocal of 127, as the port does), 256-blocks: padded, masked tails."""
    q, k, v = _qkv(sq, seed=sq + skv, Skv=skv)
    ref = K2_FLASH(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), None, 256, 256,
                   True, True)
    fa.launches.reset()
    fa.launches_qk8.reset()
    qt, kt, vt = (torch.from_numpy(x) for x in (q, k, v))
    ours = fa.flash_attention(qt, kt, vt, bounded_logits=True, qk_int8=True)
    assert ours.shape == (1, 2, sq, 64)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=ATOL, rtol=0)
    # the named plain backend is the same function
    same = tattn.full_attention(qt, kt, vt, backend="plain-qk8", bounded_logits=True)
    assert torch.equal(same, ours)
    assert fa.launches.count == 0 and fa.launches_qk8.count == 0


# K2's int32 -> fp32 route (csrc/flash_fwd_sm90.cu): the Q K^T accumulator is
# preset to the bits of 1.5 * 2^23, so the s32 sum x comes out as those bits
# plus x.
MAGIC_BITS = 0x4B400000
MAGIC = np.float32(12582912.0)
QK8_MAX = 127 * 127 * 64  # the largest |q8 . k8| at head dim 64


def test_qk8_logits_convert_exactly_through_the_magic_preset():
    """Over the whole range |x| <= 127^2 * 64 (< 2^22), the bits 0x4B400000 +
    x read as fp32, less 12582912, are float32(x): the conversion K2 makes
    without a conversion instruction is exact."""
    assert QK8_MAX < 2 ** 22
    x = np.arange(-QK8_MAX, QK8_MAX + 1, dtype=np.int64)
    as_f32 = (MAGIC_BITS + x).astype(np.uint32).view(np.float32)
    np.testing.assert_array_equal(as_f32 - MAGIC, x.astype(np.float32))
    assert as_f32[0] - MAGIC == -QK8_MAX and as_f32[-1] - MAGIC == QK8_MAX


def _jax_qk8_inputs(monkeypatch, q, k, scale):
    """The int8 codes of q and k and the fp32 logit factor as dove_tpu's
    wrapper makes them (flash_attention.py:181-197, factor as its kernel
    forms it), from a pallas_call stub that hands back its inputs."""
    captured = {}

    def stub(kernel, *, out_shape, **kw):
        def run(*inputs):
            captured["inputs"] = inputs
            return [jnp.zeros(s.shape, s.dtype) for s in out_shape]
        return run

    monkeypatch.setattr(jfa.pl, "pallas_call", stub)

    def tpu_inputs(q, k):
        jfa._flash_fwd(q, k, k, scale, 128, 128, with_lse=False, bounded=True, qk8=True)
        return captured["inputs"][:3]

    sqk, q8, k8 = jax.jit(tpu_inputs)(jnp.asarray(q), jnp.asarray(k))
    factor = np.float32(np.asarray(sqk)[0]) * np.float32(scale * fa.LOG2E)
    return np.array(q8), np.array(k8), factor


def _factor_22_bits(factor: np.float32) -> np.float32:
    """The factor as K2's FFMA uses it: rounded to 22 significant
    bits, so that 12582912 * factor (3 * 2^22 * factor) is exact."""
    bits = np.array(factor, dtype=np.float32).view(np.uint32)
    return ((bits + np.uint32(2)) & ~np.uint32(3)).view(np.float32)[()]


@pytest.mark.parametrize("wide", [False, True])
def test_qk8_logit_conversion_keeps_the_softmax(monkeypatch, wide):
    """K2's logit route emulated on JAX's own codes and factor, v = 12582912
    + x as the preset accumulator reads: one FFMA fl(v * f22 - 12582912 *
    f22) with the factor rounded to 22 significant bits is fl(x * f22),
    within a relative 2^-22 (and one rounding) of JAX's logits. Its softmax,
    P rounded to bf16 before P V as the kernel does, is within K1's bars of
    flash_attention_qk8_plain, for logits of unit size and for wide ones
    (q three times larger, p over many octaves)."""
    rng = np.random.default_rng(11)
    scale = 64 ** -0.5
    q = rng.standard_normal((2, 256, 64)).astype(np.float32) * (3.0 if wide else 1.0)
    k = rng.standard_normal((2, 384, 64)).astype(np.float32)
    v = torch.from_numpy(rng.standard_normal((1, 2, 384, 64)).astype(np.float32)
                         ).to(torch.bfloat16)
    q8, k8, factor = _jax_qk8_inputs(monkeypatch, q, k, scale)
    x = np.einsum("hqd,hkd->hqk", q8.astype(np.int64), k8.astype(np.int64))
    as_f32 = (MAGIC_BITS + x).astype(np.uint32).view(np.float32)
    jax_logits = x.astype(np.float32) * factor
    f22 = _factor_22_bits(factor)
    assert abs(np.float64(f22) / np.float64(factor) - 1) <= 2.0 ** -22
    offset = np.float32(-MAGIC * f22)
    assert np.float64(offset) == -np.float64(MAGIC) * np.float64(f22)  # exact
    # the FFMA: the product exact in float64, one rounding to fp32
    logits = (as_f32.astype(np.float64) * np.float64(f22)
              + np.float64(offset)).astype(np.float32)
    np.testing.assert_array_equal(
        logits, (x.astype(np.float64) * np.float64(f22)).astype(np.float32))
    gap = np.abs(logits.astype(np.float64) - jax_logits.astype(np.float64))
    assert (gap <= np.abs(jax_logits) * 2.0 ** -22
            + np.spacing(np.abs(jax_logits))).all()
    p = torch.from_numpy(np.exp2(logits))[None]
    ours = ((p.to(torch.bfloat16).float() @ v.float()) / p.sum(-1, keepdim=True)
            ).to(torch.bfloat16)
    ref = fa.flash_attention_qk8_plain(
        torch.from_numpy(q8)[None], torch.from_numpy(k8)[None], v,
        torch.tensor(factor))
    diff, ref = ours.float() - ref.float(), ref.float()
    max_abs = float(diff.abs().max())
    assert max_abs <= 3e-2 and max_abs <= 2e-2 * float(ref.abs().max())
    assert float(diff.square().mean().sqrt()) <= 1e-2 * float(ref.square().mean().sqrt())


def test_auto_dispatch_on_cpu_takes_the_naive_path():
    """On the CPU even a long sequence takes the naive path, and the
    launch counter does not move."""
    q, k, v = (torch.from_numpy(x) for x in _qkv(2048, seed=5, H=1, D=16))
    fa.launches.reset()
    out = tattn.full_attention(q, k, v, bounded_logits=True)
    assert torch.equal(out, tattn._naive_attention(q, k, v))
    assert fa.launches.count == 0


def test_imports_and_runs_without_nvcc_or_cuda():
    """No nvcc on PATH and no CUDA: the module imports, the CPU path runs,
    and nothing is built."""
    code = (
        "import torch\n"
        "from dove_tpu_torch import kernels\n"
        "from dove_tpu_torch.ops import flash_attention as fa\n"
        "q = torch.randn(1, 1, 8, 64)\n"
        "out = fa.flash_attention(q, q, q, bounded_logits=True)\n"
        "assert out.shape == q.shape and fa.launches.count == 0\n"
        "out = fa.flash_attention(q, q, q, bounded_logits=True, qk_int8=True)\n"
        "assert out.shape == q.shape and fa.launches_qk8.count == 0\n"
        "x = q.clone().requires_grad_()\n"
        "out, lse = fa.flash_attention(x, q, q, with_lse=True)\n"
        "out.sum().backward()\n"
        "assert x.grad.shape == q.shape and lse.shape == q.shape[:3]\n"
        "assert fa.launches_lse.count == fa.launches_bwd_dq.count == 0\n"
        "assert not kernels._loaded\n"
        "print('ok')\n"
    )
    env = {k: v for k, v in os.environ.items()
           if k not in ("CUDA_HOME", "CUDA_PATH")}
    env.update(PATH="/usr/bin:/bin", CUDA_VISIBLE_DEVICES="",
               PYTHONPATH=str(REPO))
    res = subprocess.run([sys.executable, "-c", code], env=env, cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "ok"


def test_library_path_tracks_the_source():
    path = kernels.library_path("flash_fwd_sm90")
    assert path.parent == kernels.BUILD_DIR
    assert path.name.startswith("libflash_fwd_sm90-") and path.suffix == ".so"
    assert (kernels.CSRC / "flash_fwd_sm90.cu").is_file()


def test_build_reuses_a_built_library_and_needs_nvcc_otherwise(tmp_path, monkeypatch):
    monkeypatch.setattr(kernels, "BUILD_DIR", tmp_path)
    monkeypatch.setenv("PATH", "/nonexistent")
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.delenv("CUDA_PATH", raising=False)
    if Path("/usr/local/cuda/bin/nvcc").exists():
        pytest.skip("a CUDA toolkit is installed here")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        kernels.build("flash_fwd_sm90")
    kernels.library_path("flash_fwd_sm90").touch()  # as if built before
    assert kernels.build("flash_fwd_sm90") == (0.0, "")


def test_k1_lives_in_its_own_source(monkeypatch):
    """K1's source, csrc/flash_fwd_sm90.cu, holds K2 too (its int8
    instantiation), and the wrappers of both load its library; the mma.sync
    source that held K2 is gone."""
    assert (kernels.CSRC / "flash_fwd_sm90.cu").is_file()
    assert not (kernels.CSRC / "flash_fwd.cu").exists()
    text = (kernels.CSRC / "flash_fwd_sm90.cu").read_text()
    for entry in ("dove_flash_fwd_bf16", "dove_flash_fwd_qk8"):
        assert f'extern "C" int {entry}(' in text
    assert "m64n128k32.s32.s8.s8" in text and "mma.sync" not in text

    class Fn:
        argtypes = restype = None

    loaded = []

    def fake_load(name):
        loaded.append(name)
        return type("Lib", (), {"dove_flash_fwd_bf16": Fn(), "dove_flash_fwd_qk8": Fn()})

    monkeypatch.setattr(kernels, "load", fake_load)
    fa._library()
    fa._qk8_library()
    assert loaded == ["flash_fwd_sm90", "flash_fwd_sm90"]


def test_k1_launcher_refuses_cpu_tensors_before_building():
    q = torch.zeros(1, 1, 8, 64, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="K1 runs on cuda"):
        fa.flash_fwd_launch(q, q, q, 0.125, True, False)
    assert "flash_fwd_sm90" not in kernels._loaded
