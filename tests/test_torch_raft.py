"""The port's RAFT and E*warp against dove_tpu's (CPU, fp32).

RAFT at full channels (the JAX package's ``small_channels`` miniature
splits its context features at the full hidden width, 128, and so cannot
run) on 32x48 frames: the bilinear sampler, warp and correlation lookup
within 1e-6; the flow after 12 iterations within 1e-3 px (max abs), from
the JAX package's seeded tree and from one raft-things-layout checkpoint the
test writes (context net on frozen BatchNorms, feature net on plain instance
norms), which both packages' loaders read to equal tensors. E*warp within
1e-4 relative, through the metric router of each package; the pairs in
chunks of one and in one batch within 1e-6 relative of each other.

The seeded tree's flow head is scaled by 0.1. With ``init_raft_params``'
head as it is, the update is not contractive: the flow grows to ~50 px in
12 iterations and a 1e-6 change of the input moves JAX's own flow by
~0.06 px, so there the port is held to that sensitivity instead.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dove_tpu.eval import ewarp as jewarp
from dove_tpu.eval import metrics as jmetrics
from dove_tpu.models import raft as jraft
from dove_tpu_torch.eval import ewarp as tewarp
from dove_tpu_torch.eval import metrics as tmetrics
from dove_tpu_torch.models import raft as traft
from torch_threads import two_torch_threads  # noqa: F401 (autouse)

FLOW_ATOL = 1e-3  # px, after 12 iterations
SAMPLE_ATOL = 1e-6
EWARP_REL = 1e-4
CHUNK_REL = 1e-6


HEAD_SCALE = 0.1


@pytest.fixture(scope="module")
def raw_params():
    return jax.tree.map(np.asarray, jraft.init_raft_params(jax.random.PRNGKey(0)))


@pytest.fixture(scope="module")
def jax_params(raw_params):
    head = raw_params["update"]["flow_head"]
    conv2 = dict(head["conv2"], kernel=head["conv2"]["kernel"] * HEAD_SCALE)
    update = dict(raw_params["update"], flow_head=dict(head, conv2=conv2))
    return dict(raw_params, update=update)


def _frames(seed: int, shape) -> np.ndarray:
    """Smooth frames that move by a few pixels, so the flow has content."""
    rng = np.random.default_rng(seed)
    F_, H, W, _ = shape
    base = rng.uniform(0, 1, (H // 4 + 4, W // 4 + 4, 3))
    big = np.kron(base, np.ones((4, 4, 1)))
    out = [big[t: t + H, 2 * t: 2 * t + W] for t in range(F_)]
    return np.clip(np.stack(out) + rng.normal(0, 0.02, shape), 0, 1).astype(np.float32)


def test_sampler_warp_and_lookup_match_jax():
    rng = np.random.default_rng(1)
    img = rng.normal(size=(2, 6, 9, 3)).astype(np.float32)
    coords = rng.uniform(-2, 11, (2, 4, 5, 2)).astype(np.float32)
    np.testing.assert_allclose(
        traft.bilinear_sample(torch.from_numpy(img), torch.from_numpy(coords)).numpy(),
        np.asarray(jraft.bilinear_sample(jnp.asarray(img), jnp.asarray(coords))),
        rtol=0, atol=SAMPLE_ATOL)
    flow = rng.normal(0, 2, (2, 6, 9, 2)).astype(np.float32)
    np.testing.assert_allclose(
        traft.warp(torch.from_numpy(img), torch.from_numpy(flow)).numpy(),
        np.asarray(jraft.warp(jnp.asarray(img), jnp.asarray(flow))), rtol=0, atol=SAMPLE_ATOL)
    f1 = rng.normal(size=(1, 4, 6, 8)).astype(np.float32)
    f2 = rng.normal(size=(1, 4, 6, 8)).astype(np.float32)
    pyr = traft.corr_pyramid(torch.from_numpy(f1).permute(0, 3, 1, 2),
                             torch.from_numpy(f2).permute(0, 3, 1, 2))
    ref = jraft.corr_pyramid(jnp.asarray(f1), jnp.asarray(f2))
    assert [s for _, s in pyr] == [s for _, s in ref]
    pts = rng.uniform(-1, 6, (1, 4, 6, 2)).astype(np.float32)
    np.testing.assert_allclose(
        traft.corr_lookup(pyr, torch.from_numpy(pts)).permute(0, 2, 3, 1).numpy(),
        np.asarray(jraft.corr_lookup(ref, jnp.asarray(pts))), rtol=0, atol=SAMPLE_ATOL)


def _flows(params, frames, perturb: float = 0.0):
    if perturb:
        frames = frames + np.random.default_rng(0).normal(
            0, perturb, frames.shape).astype(np.float32)
    with torch.no_grad():
        ours = traft.raft_flow(traft.from_jax_raft(params), torch.from_numpy(frames[:1]),
                               torch.from_numpy(frames[1:]), iters=12).numpy()
    ref = np.asarray(jraft.raft_flow(params, jnp.asarray(frames[:1]),
                                     jnp.asarray(frames[1:]), 12))
    return ours, ref


def test_raft_flow_matches_jax(jax_params, raw_params):
    frames = _frames(2, (2, 32, 48, 3))
    ours, ref = _flows(jax_params, frames)
    assert ours.shape == ref.shape == (1, 32, 48, 2)
    assert np.abs(ref).max() > 1.0
    np.testing.assert_allclose(ours, ref, rtol=0, atol=FLOW_ATOL)
    # the untamed head: within JAX's own change under a 1e-6 input change
    ours, ref = _flows(raw_params, frames)
    _, moved = _flows(raw_params, frames, perturb=1e-6)
    assert np.abs(ours - ref).max() <= np.abs(moved - ref).max()


def _raft_things(path, jax_params, seed: int) -> None:
    """A raft-things.pth-layout state dict: the names the port gives the
    JAX tree, the feature net's norms dropped (instance, not affine), the
    context net's norms with running statistics, BatchNorm counters and
    the downsample's copy of norm3 as torch saves them; seeded values."""
    g = torch.Generator().manual_seed(seed)
    sd = {}
    for k, v in traft.from_jax_raft(jax_params).items():
        if k.startswith("fnet.") and ".norm" in k:
            continue
        sd[k] = v * (1 + 0.05 * torch.randn(v.shape, generator=g))
        if k.startswith("cnet.") and ".norm" in k and k.endswith(".weight"):
            pre = k.removesuffix(".weight")
            sd[f"{pre}.running_mean"] = 0.1 * torch.randn(v.shape, generator=g)
            sd[f"{pre}.running_var"] = torch.rand(v.shape, generator=g) + 0.5
            sd[f"{pre}.num_batches_tracked"] = torch.tensor(7)
    for k in list(sd):
        if ".norm3." in k:
            sd[k.replace(".norm3.", ".downsample.1.")] = sd[k]
    torch.save({f"module.{k}": v for k, v in sd.items()}, path)


def test_raft_things_loader_and_ewarp_match_jax(tmp_path, monkeypatch, jax_params):
    path = tmp_path / "raft-things.pth"
    _raft_things(path, jax_params, seed=3)
    ours_w = traft.load_raft(path)
    jparams = jraft.load_raft(path)
    carried = traft.from_jax_raft(jparams)
    assert ours_w.keys() == carried.keys()
    for k in ours_w:
        assert torch.equal(ours_w[k], carried[k]), k
    assert "cnet.norm1.running_mean" in ours_w and "fnet.norm1.weight" not in ours_w
    frames = _frames(4, (3, 30, 44, 3))  # edge-padded to 32x48 for RAFT
    monkeypatch.setenv("DOVE_RAFT_WEIGHTS", str(path))
    ref = jmetrics.get_metric("ewarp")(frames)  # JAX's E*warp once, for every alias
    for name in ("ewarp", "e*warp", "warping_error"):
        ours = tmetrics.get_metric(name, device="cpu")(frames)
        assert np.isfinite(ours) and ours > 0
        assert abs(ours - ref) / abs(ref) <= EWARP_REL, (name, ours, ref)
    one = tewarp.ewarp_clip(ours_w, frames, pair_chunk=1)
    batch = tewarp.ewarp_clip(ours_w, frames, pair_chunk=len(frames))
    assert abs(one - batch) / abs(batch) <= CHUNK_REL, (one, batch)
    without = tewarp.ewarp_clip(ours_w, frames, use_occlusion=False)
    ref = jewarp.ewarp_clip(jparams, frames, use_occlusion=False)
    assert abs(without - ref) / abs(ref) <= EWARP_REL


def test_raft_rejects_sizes_not_multiple_of_8(jax_params):
    weights = traft.from_jax_raft(jax_params)
    x = torch.zeros(1, 30, 48, 3)
    with pytest.raises(ValueError, match="divisible by 8"):
        traft.raft_flow(weights, x, x)
