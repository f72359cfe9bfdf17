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
    path = kernels.library_path("flash_fwd")
    assert path.parent == kernels.BUILD_DIR
    assert path.name.startswith("libflash_fwd-") and path.suffix == ".so"
    assert (kernels.CSRC / "flash_fwd.cu").is_file()


def test_build_reuses_a_built_library_and_needs_nvcc_otherwise(tmp_path, monkeypatch):
    monkeypatch.setattr(kernels, "BUILD_DIR", tmp_path)
    monkeypatch.setenv("PATH", "/nonexistent")
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.delenv("CUDA_PATH", raising=False)
    if Path("/usr/local/cuda/bin/nvcc").exists():
        pytest.skip("a CUDA toolkit is installed here")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        kernels.build("flash_fwd")
    kernels.library_path("flash_fwd").touch()  # as if built before
    assert kernels.build("flash_fwd") == (0.0, "")


def test_k1_lives_in_its_own_source():
    """K1 (bf16, wgmma/TMA) and K2 (int8 Q K^T) build from separate sources
    into separate libraries, each named by its source and flags."""
    paths = {name: kernels.library_path(name) for name in ("flash_fwd_sm90", "flash_fwd")}
    for name, path in paths.items():
        assert (kernels.CSRC / f"{name}.cu").is_file()
        assert path.name.startswith(f"lib{name}-")
    assert paths["flash_fwd_sm90"] != paths["flash_fwd"]


def test_k1_launcher_refuses_cpu_tensors_before_building():
    q = torch.zeros(1, 1, 8, 64, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="K1 runs on cuda"):
        fa.flash_fwd_launch(q, q, q, 0.125, True, False)
    assert "flash_fwd_sm90" not in kernels._loaded
