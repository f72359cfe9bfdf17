"""The port's flow propagation and fusion against dove_tpu's (CPU, fp32).

Every function of ``dove_tpu/models/flow_fusion.py`` on the same seeded
inputs, the parameters carried across by ``from_jax_propagation`` /
``from_jax_fusion_module``. Bars: the warps, masks and resizes within 1e-5
(the nearest mode, the consistency mask and the zero-init identity equal);
the deformable conv and the learnable stacks within 1e-4 relative to the
output's largest value; ``raft_bi_clip`` (H not a multiple of 8, a clip
longer than ``short_clip_len``) within 1e-3 px, RAFT's own bar
(tests/test_torch_raft.py).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dove_tpu.models import flow_fusion as jff
from dove_tpu.models import raft as jraft
from dove_tpu_torch.models import flow_fusion as tff
from dove_tpu_torch.models import raft as traft
from torch_threads import two_torch_threads  # noqa: F401 (autouse)

ATOL = 1e-5
REL = 1e-4
FLOW_ATOL = 1e-3


def _rng(seed=0):
    return np.random.default_rng(seed)


def _t(x):
    return torch.from_numpy(np.asarray(x, np.float32))


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / (np.abs(b).max() + 1e-12))


@pytest.mark.parametrize("mode", ["bilinear", "nearest"])
def test_flow_warp(mode):
    rng = _rng(1)
    x = rng.standard_normal((2, 9, 11, 3)).astype(np.float32)
    flow = (rng.standard_normal((2, 9, 11, 2)) * 3).astype(np.float32)
    flow[0, 0, :4, 0] = [0.5, 1.5, -0.5, 2.5]  # half-pixel ties: round half to even
    ref = np.asarray(jff.flow_warp(jnp.asarray(x), jnp.asarray(flow), mode))
    ours = tff.flow_warp(_t(x), _t(flow), mode).numpy()
    np.testing.assert_allclose(ours, ref, atol=ATOL, rtol=0)
    if mode == "nearest":
        np.testing.assert_array_equal(ours, ref)


def test_fb_consistency_and_resize_flows():
    rng = _rng(2)
    fw = (rng.standard_normal((1, 10, 12, 2)) * 2).astype(np.float32)
    bw = (-fw + rng.standard_normal(fw.shape) * 0.8).astype(np.float32)
    ref = np.asarray(jff.fb_consistency(jnp.asarray(fw), jnp.asarray(bw)))
    ours = tff.fb_consistency(_t(fw), _t(bw)).numpy()
    assert 0 < ref.mean() < 1
    np.testing.assert_array_equal(ours, ref)
    flows = rng.standard_normal((1, 3, 7, 9, 2)).astype(np.float32)
    for hw in ((14, 18), (5, 6), (7, 13), (7, 9)):  # up, down (antialiased), one axis, none
        ref = np.asarray(jff.resize_flows(jnp.asarray(flows), hw))
        ours = tff.resize_flows(_t(flows), hw).numpy()
        assert ours.shape == ref.shape
        np.testing.assert_allclose(ours, ref, atol=ATOL, rtol=0)


@pytest.mark.parametrize("fn", ["optical_flow_process", "optical_flow_feature"])
@pytest.mark.parametrize("mode", ["fuse", "copy"])
def test_non_learnable_propagation(fn, mode):
    rng = _rng(3)
    x = rng.standard_normal((1, 4, 8, 10, 5)).astype(np.float32)
    ff = (rng.standard_normal((1, 3, 4, 5, 2)) * 1.5).astype(np.float32)  # resized up
    fb = (-ff + 0.3 * rng.standard_normal(ff.shape)).astype(np.float32)
    ref = getattr(jff, fn)(jnp.asarray(x), jnp.asarray(ff), jnp.asarray(fb), mode=mode)
    ours = getattr(tff, fn)(_t(x), _t(ff), _t(fb), mode=mode)
    for r, o in zip(jax.tree.leaves(ref), ours if isinstance(ours, tuple) else [ours]):
        np.testing.assert_allclose(o.numpy(), np.asarray(r), atol=ATOL, rtol=0)
    p_ref = jff.propagation_forward(None, jnp.asarray(x), jnp.asarray(ff), jnp.asarray(fb),
                                    mode=mode)
    p_ours = tff.propagation_forward(None, _t(x), _t(ff), _t(fb), mode=mode)
    np.testing.assert_allclose(p_ours.numpy(), np.asarray(p_ref), atol=ATOL, rtol=0)


def test_modulated_deform_conv():
    rng = _rng(4)
    B, H, W, Cin, Cout, G = 1, 6, 7, 8, 5, 2
    x = rng.standard_normal((B, H, W, Cin)).astype(np.float32)
    offset = (rng.standard_normal((B, H, W, G, 9, 2)) * 2).astype(np.float32)
    mask = rng.uniform(0, 1, (B, H, W, G, 9)).astype(np.float32)
    weight = rng.standard_normal((3, 3, Cin, Cout)).astype(np.float32)
    bias = rng.standard_normal(Cout).astype(np.float32)
    ref = np.asarray(jff.modulated_deform_conv(*map(jnp.asarray, (x, offset, mask, weight,
                                                                  bias))))
    ours = tff.modulated_deform_conv(_t(x), _t(offset), _t(mask),
                                     _t(weight).permute(3, 2, 0, 1), _t(bias)).numpy()
    assert _rel(ours, ref) < REL


def test_learnable_modules():
    """conv_residual_blocks, deformable_alignment and the learnable
    propagation_forward (mid_channels != in_channels: input_layer and
    output_layer), with every parameter perturbed off its init so the zero
    heads carry signal."""
    rng = _rng(5)
    C, mid, G = 4, 8, 2
    jp = jax.tree.map(np.asarray, jff.init_propagation_params(
        jax.random.PRNGKey(1), C, mid_channels=mid, groups=G))
    jp = jax.tree.map(lambda a: (a + 0.05 * rng.standard_normal(a.shape)).astype(np.float32),
                      jp)
    tp = tff.from_jax_propagation(jp)
    x = rng.standard_normal((1, 4, 8, 8, C)).astype(np.float32)
    flows = rng.standard_normal((1, 3, 8, 8, 2)).astype(np.float32)
    back = (-flows + 0.2 * rng.standard_normal(flows.shape)).astype(np.float32)

    feat = rng.standard_normal((1, 8, 8, 2 * mid)).astype(np.float32)
    ref = jff.conv_residual_blocks(jp["forward_prop"]["backbone"], jnp.asarray(feat))
    ours = tff.conv_residual_blocks(tp["forward_prop"]["backbone"], _t(feat))
    assert _rel(ours.numpy(), ref) < REL

    cur = rng.standard_normal((1, 8, 8, mid)).astype(np.float32)
    cond = np.concatenate([cur, cur[::-1], flows[:, 0], np.ones((1, 8, 8, 1), np.float32)],
                          -1)
    ref = jff.deformable_alignment(jp["backward_prop"]["deform"], jnp.asarray(cur),
                                   jnp.asarray(cond), jnp.asarray(flows[:, 0]), groups=G)
    ours = tff.deformable_alignment(tp["backward_prop"]["deform"], _t(cur), _t(cond),
                                    _t(flows[:, 0]), groups=G)
    assert _rel(ours.numpy(), ref) < REL

    ref = jff.propagation_forward(jp, jnp.asarray(x), jnp.asarray(flows),
                                  jnp.asarray(back), groups=G)
    ours = tff.propagation_forward(tp, _t(x), _t(flows), _t(back), groups=G)
    assert ours.shape == x.shape
    assert _rel(ours.numpy(), ref) < REL


def test_fusion_module():
    rng = _rng(6)
    C = 8
    jp = jax.tree.map(np.asarray, jff.init_fusion_module_params(jax.random.PRNGKey(2), C))
    x, b, f = (rng.standard_normal((1, 3, 6, 6, C)).astype(np.float32) for _ in range(3))
    ident = tff.fusion_module_forward(tff.from_jax_fusion_module(jp), _t(x), _t(b), _t(f))
    np.testing.assert_array_equal(ident.numpy(), x)  # zero-init: the identity exactly
    jp = jax.tree.map(lambda a: (a + 0.1 * rng.standard_normal(a.shape)).astype(np.float32),
                      jp)
    ref = jff.fusion_module_forward(jp, *map(jnp.asarray, (x, b, f)))
    ours = tff.fusion_module_forward(tff.from_jax_fusion_module(jp), _t(x), _t(b), _t(f))
    assert _rel(ours.numpy() - x, np.asarray(ref) - x) < REL
    seeded = tff.init_fusion_module_params(C, seed=3)
    np.testing.assert_array_equal(
        tff.fusion_module_forward(seeded, _t(x), _t(b), _t(f)).numpy(), x)


def test_seeded_propagation_params_have_the_jax_structure():
    jp = jff.init_propagation_params(jax.random.PRNGKey(0), 4, mid_channels=8, groups=2)
    tp = tff.init_propagation_params(4, mid_channels=8, groups=2, seed=0)
    carried = tff.from_jax_propagation(jax.tree.map(np.asarray, jp))
    assert (jax.tree.structure(jax.tree.map(lambda t: 0, tp))
            == jax.tree.structure(jax.tree.map(lambda t: 0, carried)))
    for a, b in zip(jax.tree.leaves(tp), jax.tree.leaves(carried)):
        assert a.shape == b.shape
    assert float(tp["backward_prop"]["deform"]["offset_out"]["kernel"].abs().max()) == 0.0


def test_raft_bi_clip():
    """H = 20 (not a multiple of 8: resized to 24 and back, antialiased
    down), 5 frames in windows of 3 sharing a boundary frame."""
    params = jax.tree.map(np.asarray, jraft.init_raft_params(jax.random.PRNGKey(0)))
    head = params["update"]["flow_head"]
    params["update"]["flow_head"] = dict(
        head, conv2=dict(head["conv2"], kernel=head["conv2"]["kernel"] * 0.1))
    clip = np.random.default_rng(0).random((1, 5, 20, 24, 3)).astype(np.float32)
    ref = jff.raft_bi_clip(params, jnp.asarray(clip), iters=2, short_clip_len=3)
    ours = tff.raft_bi_clip(traft.from_jax_raft(params), _t(clip), iters=2,
                            short_clip_len=3)
    for r, o in zip(ref, ours):
        assert o.shape == (1, 4, 20, 24, 2)
        np.testing.assert_allclose(o.numpy(), np.asarray(r), atol=FLOW_ATOL, rtol=0)


def test_use_optical_flow_loads_raft(tmp_path):
    """``use_optical_flow`` loads the frozen RAFT from ``raft_weights`` in
    ``load_components``, the JAX trainer's weights (``load_raft``) on the
    trainer's device; without the file it raises FileNotFoundError before
    any model is built, as the JAX trainer does."""
    from dove_tpu_torch.train.args import Args
    from dove_tpu_torch.train.trainer import DOVES1Trainer
    from test_torch_raft import _raft_things

    params = jax.tree.map(np.asarray, jraft.init_raft_params(jax.random.PRNGKey(0)))
    path = tmp_path / "raft-things.pth"
    _raft_things(path, params, seed=3)
    kw = dict(model_path=tmp_path / "none", base_preset="tiny", output_dir=tmp_path / "out",
              data_root=tmp_path, train_resolution=(5, 32, 32), mixed_precision="no",
              num_workers=0, use_optical_flow=True)
    tr = DOVES1Trainer(Args(**kw, raft_weights=path), device="cpu")
    tr.load_components()
    carried = traft.from_jax_raft(jraft.load_raft(path))
    assert tr.raft.keys() == carried.keys()
    assert all(torch.equal(tr.raft[k], carried[k]) for k in carried)
    missing = DOVES1Trainer(Args(**kw, raft_weights=tmp_path / "absent.pth"), device="cpu")
    with pytest.raises(FileNotFoundError, match="raft_weights"):
        missing.load_components()
    assert not hasattr(missing, "dit")
