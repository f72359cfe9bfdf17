"""The port's int8 DiT quantization (dove_tpu_torch.ops.quant) against dove_tpu.

fp32 on the CPU. The JAX functions run under ``jax.jit``, as the pipeline
compiles them: XLA turns the division by 127 into a product with its fp32
reciprocal there, and the port computes the scale that way. Codes may then
differ only where a value sits on a rounding tie; every scale is identical.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dove_tpu import config as jcfg
from dove_tpu.models import dit as jdit
from dove_tpu.models import vae as jvae
from dove_tpu.ops import quant as jquant
from dove_tpu.ops.pallas import flash_attention as jfa
from dove_tpu_torch import config as tcfg
from dove_tpu_torch import weights as tweights
from dove_tpu_torch.ops import flash_attention as fa
from dove_tpu_torch.ops import quant

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

ATOL = 1e-4  # the DiT forward, as tests/test_torch_dit.py holds the bf16 one
REL = 1e-5  # qlinear's output, relative to its largest value


def _rows(seed: int, m: int = 37, k: int = 48) -> np.ndarray:
    """Activations with one outlier row, so the per-row scales differ."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((m, k)).astype(np.float32)
    x[5] *= 40.0
    return x


def _codes_agree(ours: np.ndarray, ref: np.ndarray, x_over_s: np.ndarray) -> None:
    """int8 codes equal, except by one step where x / s is a rounding tie."""
    diff = np.abs(ours.astype(int) - ref.astype(int))
    assert diff.max() <= 1
    frac = np.abs(np.abs(x_over_s - np.trunc(x_over_s)) - 0.5)
    assert np.all(frac[diff > 0] < 1e-4), "codes differ away from a tie"


def test_dynamic_quant_rows_matches_jax():
    x = _rows(0)
    xq_ref, s_ref = jax.jit(jquant.dynamic_quant_rows)(jnp.asarray(x))
    xq, s = quant.dynamic_quant_rows(torch.from_numpy(x))
    assert xq.dtype == torch.int8 and s.shape == (37, 1) and s.dtype == torch.float32
    np.testing.assert_array_equal(s.numpy(), np.asarray(s_ref))
    _codes_agree(xq.numpy(), np.asarray(xq_ref), x / s.numpy())


@pytest.mark.parametrize("bias", [False, True])
def test_qlinear_matches_jax(bias):
    rng = np.random.default_rng(1)
    x = _rows(2).reshape(1, 37, 48)
    w = rng.standard_normal((48, 24)).astype(np.float32) * 0.1  # JAX [in, out]
    p = jquant._quantize_leaf_dict({"kernel": jnp.asarray(w)}, donate=False)
    if bias:
        p["bias"] = jnp.asarray(rng.standard_normal(24).astype(np.float32))
    ref = np.asarray(jax.jit(jquant.qlinear)(p, jnp.asarray(x)))
    w_q, scale = quant.quantize_weight(torch.from_numpy(w.T.copy()))
    np.testing.assert_array_equal(w_q.numpy(), np.asarray(p["kernel_q"]).T)
    np.testing.assert_array_equal(scale.numpy(), np.asarray(p["kernel_scale"]))
    b = torch.tensor(np.asarray(p["bias"])) if bias else None
    ours = quant.qlinear(torch.from_numpy(x), w_q, scale, b).numpy()
    assert ours.shape == ref.shape == (1, 37, 24)
    assert np.abs(ours - ref).max() <= REL * np.abs(ref).max()


@pytest.mark.parametrize("m,k,n", [(3, 20, 10), (40, 64, 24)])
def test_int8_matmul_is_exact(m, k, n):
    """torch._int_mm with zero padding up to what it takes on the card
    (more than 16 rows, K and N multiples of 8) against an int64 product."""
    rng = np.random.default_rng(m)
    a = rng.integers(-127, 128, (m, k), dtype=np.int8)
    b = rng.integers(-127, 128, (n, k), dtype=np.int8)
    acc = quant.int8_matmul(torch.from_numpy(a), torch.from_numpy(b))
    assert acc.dtype == torch.int32 and acc.shape == (m, n)
    np.testing.assert_array_equal(acc.numpy(), a.astype(np.int64) @ b.astype(np.int64).T)


def test_k2_quantizer_matches_the_tpu_wrapper(monkeypatch):
    """K2's quantizer against the one in dove_tpu's flash-attention wrapper
    (flash_attention.py:185-197): the pallas_call is replaced by a stub that
    hands back its inputs, the int8 codes of q and k and s_q * s_k."""
    captured = {}

    def stub(kernel, *, out_shape, **kw):
        def run(*inputs):
            captured["inputs"] = inputs
            return [jnp.zeros(s.shape, s.dtype) for s in out_shape]
        return run

    monkeypatch.setattr(jfa.pl, "pallas_call", stub)
    rng = np.random.default_rng(4)
    q = rng.standard_normal((2, 256, 64)).astype(np.float32) * 3.0
    k = rng.standard_normal((2, 256, 64)).astype(np.float32)

    def tpu_inputs(q, k):
        jfa._flash_fwd(q, k, k, 0.125, 128, 128, with_lse=False, bounded=True,
                       qk8=True)
        return captured["inputs"][:3]

    sqk_ref, q8_ref, k8_ref = jax.jit(tpu_inputs)(jnp.asarray(q), jnp.asarray(k))
    q8, s_q = fa.quantize_qk(torch.from_numpy(q))
    k8, s_k = fa.quantize_qk(torch.from_numpy(k))
    np.testing.assert_array_equal(q8.numpy(), np.asarray(q8_ref))
    np.testing.assert_array_equal(k8.numpy(), np.asarray(k8_ref))
    np.testing.assert_array_equal((s_q * s_k).reshape(1).numpy(), np.asarray(sqk_ref))


def test_k2_quantizer_floor_is_1e6():
    """An all-zero tensor takes the floor 1e-6 / 127 (not the linears'
    1e-12) and codes to zeros."""
    q8, s = fa.quantize_qk(torch.zeros(1, 1, 4, 64))
    assert torch.equal(q8, torch.zeros_like(q8))
    assert s.item() == pytest.approx(1e-6 / 127.0, rel=1e-6)


@pytest.fixture(scope="module")
def tiny_trees():
    cfg_j = jcfg.tiny_test()
    rng = np.random.default_rng(1)
    dit_tree = jax.tree.map(
        lambda x: np.asarray(x) + 0.05 * rng.standard_normal(x.shape).astype(np.float32),
        jdit.init_dit_params(jax.random.PRNGKey(0), cfg_j.dit))
    vae_tree = jax.tree.map(np.asarray,
                            jvae.init_vae_params(jax.random.PRNGKey(1), cfg_j.vae))
    return cfg_j, dit_tree, vae_tree


def _quantized_linears(dit):
    return {name: mod for name, mod in dit.named_modules()
            if isinstance(mod, (quant.QLinear, quant.W8Linear))}


@pytest.mark.parametrize("w_only", [False, True])
def test_quantize_dit_matches_jax_through_from_jax_params(tiny_trees, w_only):
    """JAX quantize_dit carried over by from_jax_params, against the port's
    quantize_dit on the carried fp32 tree: the same six linears per block,
    with identical codes and scales."""
    cfg_j, dit_tree, vae_tree = tiny_trees
    jq = jquant.quantize_dit(jax.tree.map(jnp.asarray, dit_tree), donate=False,
                             w_only=w_only)
    cfg_t = tcfg.tiny_test()
    carried, _ = tweights.from_jax_params(cfg_t, jax.tree.map(np.asarray, jq), vae_tree)
    plain, _ = tweights.from_jax_params(cfg_t, dit_tree, vae_tree)
    ours = quant.quantize_dit(plain, w_only=w_only)
    a, b = _quantized_linears(carried), _quantized_linears(ours)
    cls = quant.W8Linear if w_only else quant.QLinear
    assert sorted(a) == sorted(b)
    assert len(a) == 6 * cfg_t.dit.num_layers
    assert all(type(m) is cls for m in (*a.values(), *b.values()))
    for name in a:
        assert torch.equal(a[name].weight_q, b[name].weight_q), name
        assert torch.equal(a[name].scale, b[name].scale), name
        assert a[name].scale.dtype == torch.float32
        assert torch.equal(a[name].bias, b[name].bias), name
    # the rest of the block stays as it was
    assert isinstance(ours.transformer_blocks[0].norm1.linear, torch.nn.Linear)


@pytest.mark.parametrize("w_only", [False, True])
def test_quantized_dit_forward_matches_jax(tiny_trees, w_only):
    """The int8-dit (W8A8) and int8w (W8A16) DiT forward against JAX's, on
    one set of int8 weights, naive attention on both sides."""
    cfg_j, dit_tree, vae_tree = tiny_trees
    jq = jquant.quantize_dit(jax.tree.map(jnp.asarray, dit_tree), donate=False,
                             w_only=w_only)
    dit, _ = tweights.from_jax_params(tcfg.tiny_test(), jax.tree.map(np.asarray, jq),
                                      vae_tree)
    rng = np.random.default_rng(2)
    latent = rng.standard_normal((1, 4, 8, 8, 8)).astype(np.float32)
    text = rng.standard_normal((1, 7, 32)).astype(np.float32)
    t = np.array([399], np.int32)
    fwd = jax.jit(lambda p, x, c, tt: jdit.dit_forward(p, cfg_j.dit, x, c, tt,
                                                       bounded_logits=True))
    ref = fwd(jq, jnp.asarray(latent), jnp.asarray(text), jnp.asarray(t))
    with torch.no_grad():
        ours = dit(torch.from_numpy(latent), torch.from_numpy(text),
                   torch.from_numpy(t), attention_backend="naive",
                   bounded_logits=True)
    assert ours.shape == ref.shape
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=ATOL, rtol=0)


def test_quantize_dit_in_place_and_idempotent(tiny_trees):
    cfg_j, dit_tree, vae_tree = tiny_trees
    dit, _ = tweights.from_jax_params(tcfg.tiny_test(), dit_tree, vae_tree)
    n_linear = sum(isinstance(m, torch.nn.Linear) for m in dit.modules())
    assert quant.quantize_dit(dit) is dit
    first = {k: v.weight_q.clone() for k, v in _quantized_linears(dit).items()}
    quant.quantize_dit(dit)  # already int8: left as it is
    assert {k: v.weight_q for k, v in _quantized_linears(dit).items()}.keys() == first.keys()
    assert all(torch.equal(first[k], v.weight_q)
               for k, v in _quantized_linears(dit).items())
    assert sum(isinstance(m, torch.nn.Linear) for m in dit.modules()) == (
        n_linear - len(first))
    with pytest.raises(ValueError, match="cannot requantize"):
        quant.quantize_dit(dit, w_only=True)


def test_int8_modules_keep_fp32_scales_under_a_dtype_cast():
    lin = torch.nn.Linear(16, 8)
    q = quant.QLinear.from_linear(lin).to(torch.bfloat16)
    assert q.weight_q.dtype == torch.int8
    assert q.scale.dtype == torch.float32
    assert q.bias.dtype == torch.bfloat16
    w8 = quant.W8Linear.from_linear(lin)
    x = torch.randn(3, 16)
    deq = w8.weight_q.float() * w8.scale[:, None]
    torch.testing.assert_close(w8(x), x @ deq.T + lin.bias.detach(), rtol=0, atol=1e-6)
