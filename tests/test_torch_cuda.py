"""Tests of the PyTorch port that need an NVIDIA GPU (marked ``cuda``).

They skip on a machine without one. The machine with the card has no JAX, so
this file imports only torch and dove_tpu_torch, and runs there without the
JAX-loading conftest:

    python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_cuda.py
"""

from __future__ import annotations

import math
import time

import pytest
import torch

from dove_tpu_torch import obs
from dove_tpu_torch.ops import conv3d_int8 as tconv
from dove_tpu_torch.ops import flash_attention as fa
from dove_tpu_torch.ops import quant

# bf16 bars, as chip_smoke.py holds K1: the absolute bar of
# tests/test_flash_attention.py, and the error relative to the reference's
# largest value and to its RMS (a typical output is ~0.026 at S=4097).
ABS_TOL, REL_MAX_TOL, REL_RMS_TOL = 3e-2, 2e-2, 1e-2


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernel, no interpret mode)")
    return torch.device("cuda")


def _randn(shape, seed: int, dev, dtype=torch.bfloat16):
    gen = torch.Generator(device=dev).manual_seed(seed)
    return torch.randn(shape, generator=gen, device=dev, dtype=dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("sq,skv", [(200, 200), (4097, 4097), (130, 300)])
def test_kernel_matches_plain_on_card(sq, skv):
    dev = _card()
    q = _randn((1, 4, sq, 64), 1, dev)
    k = _randn((1, 4, skv, 64), 2, dev)
    v = _randn((1, 4, skv, 64), 3, dev)
    for bounded in (False, True):
        before = fa.launches.count
        out = fa.flash_attention(q, k, v, bounded_logits=bounded)
        torch.cuda.synchronize()
        assert fa.launches.count == before + 1
        ref = fa.flash_attention_plain(q, k, v, bounded_logits=bounded)
        assert out.shape == q.shape and out.dtype == torch.bfloat16
        diff, ref = out.float() - ref.float(), ref.float()
        max_abs = float(diff.abs().max())
        assert max_abs <= ABS_TOL
        assert max_abs <= REL_MAX_TOL * float(ref.abs().max())
        assert float(diff.square().mean().sqrt()) <= (
            REL_RMS_TOL * float(ref.square().mean().sqrt()))


@pytest.mark.cuda
def test_wrapper_raises_on_what_the_kernel_does_not_take():
    dev = _card()
    q = _randn((1, 2, 64, 64), 4, dev)
    before = fa.launches.count
    with pytest.raises(ValueError, match="bfloat16"):
        fa.flash_attention(q.float(), q.float(), q.float())
    with pytest.raises(ValueError, match="head_dim"):
        d128 = _randn((1, 2, 64, 128), 5, dev)
        fa.flash_attention(d128, d128, d128)
    with pytest.raises(ValueError, match="contiguous"):
        t = q.transpose(1, 2)
        fa.flash_attention(t, t, t)
    with pytest.raises(ValueError, match="16-byte aligned"):  # K1's TMA loads
        t = torch.empty(q.numel() + 1, device=dev, dtype=q.dtype)[1:].view(q.shape)
        fa.flash_attention(t, t, t)
    with pytest.raises(NotImplementedError):  # K2 is inference only
        fa.flash_attention(q, q, q, bounded_logits=True, qk_int8=True, with_lse=True)
    with pytest.raises(ValueError, match="requires bounded_logits"):
        fa.flash_attention(q, q, q, qk_int8=True)
    with pytest.raises(ValueError, match="bfloat16"):  # K2 takes bf16 too
        fa.flash_attention(q.float(), q.float(), q.float(), bounded_logits=True,
                           qk_int8=True)
    assert fa.launches.count == before


# K1 (csrc/flash_fwd_sm90.cu) streams 128-key tiles through 3-D TMA maps over
# [b*h, S, 64] and stores 192-query tiles row by row: lengths around the tile
# edges, and B*H = 3 so that every head has neighbours.
RAGGED = (1, 63, 64, 65, 127, 128, 129, 191, 192, 193, 4097)
K1_FORMS = [(bounded, with_lse) for bounded in (False, True) for with_lse in (False, True)]


def _k1_form(q, k, v, bounded: bool, with_lse: bool):
    """(out, lse or None) of K1 in one form, and of its plain version;
    checks the form's counter took one launch."""
    counter = fa.launches_lse if with_lse else fa.launches
    before = counter.count
    got = fa.flash_attention(q, k, v, bounded_logits=bounded, with_lse=with_lse)
    torch.cuda.synchronize()
    assert counter.count == before + 1
    want = fa.flash_attention_plain(q, k, v, bounded_logits=bounded, with_lse=with_lse)
    if not with_lse:
        got, want = (got, None), (want, None)
    return got, want


@pytest.mark.cuda
@pytest.mark.parametrize("skv", RAGGED)
@pytest.mark.parametrize("sq", RAGGED)
def test_k1_forms_at_ragged_lengths_on_card(sq, skv):
    """All four forms of K1 at Sq, Skv around its 128- and 192-row tiles,
    against their plain versions at K1's bars (the logsumexp at LSE_TOL)."""
    dev = _card()
    q = _randn((1, 3, sq, 64), 20 + sq, dev)
    k = _randn((1, 3, skv, 64), 30 + skv, dev)
    v = _randn((1, 3, skv, 64), 40 + skv, dev)
    for bounded, with_lse in K1_FORMS:
        (out, lse), (ref, ref_lse) = _k1_form(q, k, v, bounded, with_lse)
        assert out.shape == q.shape and out.dtype == torch.bfloat16
        assert bool(torch.isfinite(out).all())
        _assert_within_bars(out, ref)
        if with_lse:
            assert lse.shape == (1, 3, sq) and lse.dtype == torch.float32
            assert float((lse - ref_lse).abs().max()) <= LSE_TOL


@pytest.mark.cuda
@pytest.mark.parametrize("sq,skv", [(129, 193), (193, 65), (4097, 129)])
def test_k1_reads_and_writes_nothing_across_a_head(sq, skv):
    """Heads 0 and 2 are NaN: a K or V tile read past the end of head 1, or a
    Q tile's store past its end, would carry NaN into head 1 or head 1's
    values into head 2."""
    dev = _card()
    q = _randn((1, 3, sq, 64), 50, dev)
    k = _randn((1, 3, skv, 64), 51, dev)
    v = _randn((1, 3, skv, 64), 52, dev)
    for t in (q, k, v):
        t[:, 0::2] = float("nan")
    mid = [t[:, 1:2].contiguous() for t in (q, k, v)]
    for bounded, with_lse in K1_FORMS:
        out = fa.flash_attention(q, k, v, bounded_logits=bounded, with_lse=with_lse)
        torch.cuda.synchronize()
        (out, lse) = out if with_lse else (out, None)
        ref = fa.flash_attention_plain(*mid, bounded_logits=bounded, with_lse=with_lse)
        (ref, ref_lse) = ref if with_lse else (ref, None)
        assert bool(torch.isfinite(out[:, 1]).all())
        _assert_within_bars(out[:, 1:2], ref)
        assert bool(torch.isnan(out[:, 0::2].float()).all())
        if with_lse:
            assert float((lse[:, 1:2] - ref_lse).abs().max()) <= LSE_TOL


@pytest.mark.cuda
@pytest.mark.parametrize("bounded", [False, True])
def test_k1_when_the_row_max_rises_late_on_card(bounded):
    """Keys from 600 on have 6x the logits: the online form's running max,
    taken on the first tile, is then exceeded by far more than 2^8 and must
    move (the rare path that redoes a tile's exponentials)."""
    dev = _card()
    q = _randn((2, 3, 300, 64), 60, dev)
    k = _randn((2, 3, 1000, 64), 61, dev)
    v = _randn((2, 3, 1000, 64), 62, dev)
    k[:, :, 600:] *= 6
    for with_lse in (False, True):
        (out, lse), (ref, ref_lse) = _k1_form(q, k, v, bounded, with_lse)
        assert bool(torch.isfinite(out).all())
        _assert_within_bars(out, ref)
        if with_lse:
            assert float((lse - ref_lse).abs().max()) <= LSE_TOL


def _assert_within_bars(out: torch.Tensor, ref: torch.Tensor,
                        grad: bool = False) -> None:
    """K1's bars. grad: a gradient of any size, whose absolute bar scales
    with its largest value past 1 (summed over thousands of rows it reaches
    |x| ~ 8, where one bf16 ulp is 0.0625 and two fp32 sums in another order
    may round to neighbours)."""
    diff, ref = out.float() - ref.float(), ref.float()
    max_abs = float(diff.abs().max())
    assert max_abs <= ABS_TOL * (max(1.0, float(ref.abs().max())) if grad else 1.0)
    assert max_abs <= REL_MAX_TOL * float(ref.abs().max())
    assert float(diff.square().mean().sqrt()) <= (
        REL_RMS_TOL * float(ref.square().mean().sqrt()))


# K1's logsumexp against its plain version: fp32 on both sides from the same
# bf16 inputs, differing in summation order and in ex2.approx.
LSE_TOL = 1e-3


@pytest.mark.cuda
@pytest.mark.parametrize("sq,skv", [(200, 200), (130, 300)])
@pytest.mark.parametrize("bounded", [False, True])
def test_k1_lse_and_k3_match_plain_on_card(sq, skv, bounded):
    """K1's training form (output and logsumexp), then K3a and K3b on the
    same inputs, against their plain versions at K1's bars; each kernel
    counts one launch."""
    dev = _card()
    q = _randn((2, 3, sq, 64), 11, dev)
    k = _randn((2, 3, skv, 64), 12, dev)
    v = _randn((2, 3, skv, 64), 13, dev)
    do = _randn((2, 3, sq, 64), 14, dev)
    counters = (fa.launches, fa.launches_lse, fa.launches_bwd_dq, fa.launches_bwd_dkv)
    before = [c.count for c in counters]
    out, lse = fa.flash_attention(q, k, v, bounded_logits=bounded, with_lse=True)
    ref, ref_lse = fa.flash_attention_plain(q, k, v, bounded_logits=bounded,
                                            with_lse=True)
    _assert_within_bars(out, ref)
    assert lse.shape == (2, 3, sq) and lse.dtype == torch.float32
    assert float((lse - ref_lse).abs().max()) <= LSE_TOL
    delta = (do.float() * out.float()).sum(-1)
    dq = fa.flash_bwd_dq_launch(q, k, v, do, lse, delta, 0.125)
    dk, dv = fa.flash_bwd_dkv_launch(q, k, v, do, lse, delta, 0.125)
    torch.cuda.synchronize()
    assert [c.count - b for c, b in zip(counters, before)] == [0, 1, 1, 1]
    ref_dq = fa.flash_bwd_dq_plain(q, k, v, do, lse, delta, 0.125)
    ref_dk, ref_dv = fa.flash_bwd_dkv_plain(q, k, v, do, lse, delta, 0.125)
    for got, want in ((dq, ref_dq), (dk, ref_dk), (dv, ref_dv)):
        assert got.dtype == torch.bfloat16 and got.shape == want.shape
        _assert_within_bars(got, want)


def _k3_case(q, k, v, do, bounded: bool):
    """K1's training form on (q, k, v), then K3a and K3b on its output and
    logsumexp -> ((dq, dk, dv), (lse, delta)); checks each backward kernel
    took one launch."""
    out, lse = fa.flash_attention(q, k, v, bounded_logits=bounded, with_lse=True)
    delta = (do.float() * out.float()).sum(-1)
    before = fa.launches_bwd_dq.count, fa.launches_bwd_dkv.count
    dq = fa.flash_bwd_dq_launch(q, k, v, do, lse, delta, 0.125)
    dk, dv = fa.flash_bwd_dkv_launch(q, k, v, do, lse, delta, 0.125)
    torch.cuda.synchronize()
    assert (fa.launches_bwd_dq.count, fa.launches_bwd_dkv.count) == (
        before[0] + 1, before[1] + 1)
    return (dq, dk, dv), (lse, delta)


def _k3_plain(q, k, v, do, lse, delta):
    return (fa.flash_bwd_dq_plain(q, k, v, do, lse, delta, 0.125),
            *fa.flash_bwd_dkv_plain(q, k, v, do, lse, delta, 0.125))


@pytest.mark.cuda
@pytest.mark.parametrize("skv", RAGGED)
@pytest.mark.parametrize("sq", RAGGED)
def test_k3_at_ragged_lengths_on_card(sq, skv):
    """K3a (192-query CTAs, 64-key tiles) and K3b (128-key CTAs, 64-query
    tiles) at Sq, Skv around their tiles, on the output and logsumexp of
    both K1 training forms, against their plain versions at K1's bars."""
    dev = _card()
    q = _randn((1, 3, sq, 64), 70 + sq, dev)
    k = _randn((1, 3, skv, 64), 80 + skv, dev)
    v = _randn((1, 3, skv, 64), 90 + skv, dev)
    do = _randn((1, 3, sq, 64), 100 + sq, dev)
    for bounded in (False, True):
        grads, (lse, delta) = _k3_case(q, k, v, do, bounded)
        for name, got, want in zip("qkv", grads, _k3_plain(q, k, v, do, lse, delta)):
            assert got.shape == want.shape and got.dtype == torch.bfloat16
            assert bool(torch.isfinite(got).all())
            if skv == 1 and name in "qk" and float(want.abs().max()) <= ZERO_GRAD_TOL:
                # one key, online form: p = 1 and o = v exactly, so ds =
                # dO.v - delta and dQ, dK are 0; both sides hold only the
                # rounding residue of two fp32 dot products, where a
                # relative bar means nothing. (The bounded form rounds an
                # unnormalised p to bf16, so its o is not v and its dQ, dK
                # are real values, held to the bars.)
                assert float(got.float().abs().max()) <= ZERO_GRAD_TOL
            else:
                _assert_within_bars(got, want, grad=True)


def _stage2_seq_len(h: int, w: int) -> int:
    """Joint tokens of a stage-2 DiT pass on h x w frames: every frame is a
    clip of its own, one latent; a clip of two frames (or an image and its
    copy) is one latent pair."""
    from dove_tpu_torch import cogvideox1_5_5b

    cfg = cogvideox1_5_5b()
    patch = cfg.vae.spatial_scale * cfg.dit.patch_size
    return cfg.dit.max_text_seq_length + (h // patch) * (w // patch)


@pytest.mark.cuda
@pytest.mark.parametrize("bounded", [False, True])
def test_k1_lse_and_k3_at_the_stage2_shape(bounded):
    """scripts/train_s2.sh's attention, [1, 48, 1026, 64] (226 text tokens
    and 20 x 40 patches of 320 x 640 frames): K1's training form, K3a and K3b
    against their plain versions at K1's bars."""
    dev = _card()
    S = _stage2_seq_len(320, 640)
    assert S == 1026
    q, k, v, do = (_randn((1, 48, S, 64), seed, dev) for seed in (130, 131, 132, 133))
    (out, lse), (ref, ref_lse) = _k1_form(q, k, v, bounded, True)
    _assert_within_bars(out, ref)
    assert float((lse - ref_lse).abs().max()) <= LSE_TOL
    grads, (lse, delta) = _k3_case(q, k, v, do, bounded)
    for got, want in zip(grads, _k3_plain(q, k, v, do, lse, delta)):
        assert bool(torch.isfinite(got).all())
        _assert_within_bars(got, want, grad=True)


@pytest.mark.cuda
def test_stage2_step_through_kernels_matches_plain(tmp_path):
    """One DOVES2Trainer SFT step (per-frame encode, DiT, decode with
    gradients, DISTS on a seeded VGG16, frame differences) at full width and
    2 DiT layers on a 2 x 160 x 320 clip, through the kernels and through the
    plain attention: the whole step's loss terms within 1e-2 and its
    launches (two K1-lse per layer under checkpointing, one K3a and one
    K3b); on the DiT's part of the step (x0, and the gradients for one
    seeded cotangent on it) x0 within 1e-2 RMS and every DiT gradient within
    5e-2 RMS, chip_smoke.py's bars for the training step (phase 16 says why
    the whole step's gradients are not held to them)."""
    import dataclasses

    from dove_tpu_torch import cogvideox1_5_5b
    from dove_tpu_torch.train import losses
    from dove_tpu_torch.train.args import Args
    from dove_tpu_torch.train.trainer import DOVES2Trainer

    dev = _card()
    base = cogvideox1_5_5b()
    cfg = dataclasses.replace(base, dit=dataclasses.replace(base.dit, num_layers=2))
    args = Args(model_path=tmp_path / "none", model_name="dove-s2", training_type="sft",
                output_dir=tmp_path / "out", train_resolution=(2, 160, 320),
                batch_size=1, mixed_precision="bf16", gradient_checkpointing=True,
                sr_noise_step=399, noise_step=0, dists_weight=1.0, frame_diff_weight=1.0,
                allow_random_perceptual=True, num_workers=0)
    tr = DOVES2Trainer(args, pipeline_config=cfg, device=dev)
    tr.load_components()
    assert tr.attention_backend == "flash"
    hq = _randn((1, 2, 160, 320, 3), 140, dev, torch.float32).clamp(-1, 1)
    lq = _randn((1, 2, 160, 320, 3), 141, dev, torch.float32).clamp(-1, 1)
    batch = tr.device_batch({"hq_video": hq, "lq_video": lq})
    cot = _randn((1, 2, 20, 40, 16), 142, dev)
    params = list(tr.dit.parameters())
    counters = (fa.launches_lse, fa.launches_bwd_dq, fa.launches_bwd_dkv)
    runs = {}
    for backend in ("flash", "plain"):
        tr.attention_backend = backend
        before = [c.count for c in counters]
        _, aux, _ = tr.loss_and_grads(batch)
        counts = [c.count - b for c, b in zip(counters, before)]
        lq_lat = tr._encode(batch["lq_video"], None, per_frame=True).to(tr.dtype)
        x0 = losses.one_step_x0_latent(cfg, tr.schedule, tr.dit, lq_lat,
                                       batch["prompt_embeds"], None, **tr.dit_kwargs())
        grads = torch.autograd.grad(x0, params, cot, allow_unused=True)
        runs[backend] = ({k: float(v) for k, v in aux.items()}, counts, x0.detach(),
                         [torch.zeros_like(p) if g is None else g
                          for p, g in zip(params, grads)])
    (k_aux, k_counts, k_x0, k_grads), (p_aux, p_counts, p_x0, p_grads) = (
        runs["flash"], runs["plain"])
    assert k_counts == [4, 2, 2] and p_counts == [0, 0, 0]
    assert set(k_aux) == {"loss", "loss_pixel", "loss_perceptual", "loss_frame_diff"}
    for key, x in k_aux.items():
        assert abs(x - p_aux[key]) <= 1e-2 * abs(p_aux[key])

    def rms(t):
        return float(t.float().square().mean().sqrt())

    assert rms(k_x0 - p_x0.float()) <= 1e-2 * rms(p_x0)
    nonzero = 0
    for name, g, h in zip([n for n, _ in tr.dit.named_parameters()], k_grads, p_grads):
        if float(h.abs().max()) == 0.0:
            assert float(g.abs().max()) == 0.0, name
            continue
        nonzero += 1
        assert rms(g.float() - h.float()) <= 5e-2 * rms(h), name
    assert nonzero >= len(k_grads) // 2


# the residue that a zero gradient may show: fp32 dot products of 64 bf16
# products of unit-variance values, apart in summation order, times |k|
ZERO_GRAD_TOL = 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize("sq,skv", [(129, 193), (193, 65), (4097, 129), (65, 4097)])
def test_k3_reads_and_writes_nothing_across_a_head(sq, skv):
    """Heads 0 and 2 are NaN (q, k, v, dO, lse and delta): a tile read past
    the end of head 1 (K3b's lse and delta slices do read on into the next
    head, and its last tile must mask them), or a store past its end, would
    carry NaN into head 1's gradients or head 1's values into head 2's."""
    dev = _card()
    q = _randn((1, 3, sq, 64), 110, dev)
    k = _randn((1, 3, skv, 64), 111, dev)
    v = _randn((1, 3, skv, 64), 112, dev)
    do = _randn((1, 3, sq, 64), 113, dev)
    out, lse = fa.flash_attention(q, k, v, with_lse=True)
    delta = (do.float() * out.float()).sum(-1)
    for t in (q, k, v, do, lse, delta):
        t[:, 0::2] = float("nan")
    grads = (fa.flash_bwd_dq_launch(q, k, v, do, lse, delta, 0.125),
             *fa.flash_bwd_dkv_launch(q, k, v, do, lse, delta, 0.125))
    torch.cuda.synchronize()
    refs = _k3_plain(*(t[:, 1:2].contiguous() for t in (q, k, v, do, lse, delta)))
    for got, want in zip(grads, refs):
        assert bool(torch.isfinite(got[:, 1]).all())
        _assert_within_bars(got[:, 1:2], want, grad=True)
        assert bool(torch.isnan(got[:, 0::2].float()).all())


@pytest.mark.cuda
def test_k3_wrapper_raises_on_what_the_kernels_do_not_take():
    """Misaligned data (the TMA loads) and a float32 dO raise before any
    launch; nothing falls back to the plain version."""
    dev = _card()
    q, k, v, do = (_randn((1, 2, 100, 64), s, dev) for s in (120, 121, 122, 123))
    lse = torch.zeros((1, 2, 100), device=dev)
    delta = torch.zeros((1, 2, 100), device=dev)
    before = fa.launches_bwd_dq.count, fa.launches_bwd_dkv.count
    with pytest.raises(ValueError, match="do must be"):
        fa.flash_bwd_dq_launch(q, k, v, do.float(), lse, delta, 0.125)
    odd = torch.empty(do.numel() + 1, device=dev, dtype=do.dtype)[1:].view(do.shape)
    with pytest.raises(ValueError, match="16-byte aligned"):
        fa.flash_bwd_dkv_launch(q, k, v, odd, lse, delta, 0.125)
    assert (fa.launches_bwd_dq.count, fa.launches_bwd_dkv.count) == before


@pytest.mark.cuda
def test_flash_autograd_on_card_matches_plain_autograd():
    """Gradients through FlashAttention on the card (K1 with lse, K3a, K3b)
    against the same function on the plain versions (backend "plain")."""
    from dove_tpu_torch.ops import attention as tattn

    dev = _card()
    q, k, v = (_randn((1, 4, 333, 64), s, dev).requires_grad_() for s in (15, 16, 17))
    g = _randn((1, 4, 333, 64), 18, dev)
    grads = {}
    for backend in ("flash", "plain"):
        out = tattn.full_attention(q, k, v, backend=backend)
        grads[backend] = torch.autograd.grad(out, (q, k, v), g)
    for got, want in zip(grads["flash"], grads["plain"]):
        _assert_within_bars(got, want)


# K2 (csrc/flash_fwd_sm90.cu, K1's kernel with int8 Q and K) at K1's tile
# edges, and the cases its first port was tested at.
K2_CASES = [(200, 200), (130, 300), (1, 77)] + [(sq, skv) for sq in RAGGED
                                                for skv in RAGGED]


@pytest.mark.cuda
@pytest.mark.parametrize("sq,skv", K2_CASES)
def test_k2_matches_plain_on_card(sq, skv):
    """K2 on bf16 inputs against its plain version on the same int8 codes,
    at K1's bars; each call adds one to K2's counter and none to K1's."""
    dev = _card()
    q = _randn((1, 4, sq, 64), 6, dev)
    k = _randn((1, 4, skv, 64), 7, dev)
    v = _randn((1, 4, skv, 64), 8, dev)
    before, before_k1 = fa.launches_qk8.count, fa.launches.count
    out = fa.flash_attention(q, k, v, bounded_logits=True, qk_int8=True)
    torch.cuda.synchronize()
    assert fa.launches_qk8.count == before + 1 and fa.launches.count == before_k1
    q8, k8, factor = fa.quantize_qk_pair(q, k, 64 ** -0.5)
    ref = fa.flash_attention_qk8_plain(q8, k8, v, factor)
    assert out.shape == q.shape and out.dtype == torch.bfloat16
    assert bool(torch.isfinite(out).all())
    _assert_within_bars(out, ref)


@pytest.mark.cuda
@pytest.mark.parametrize("sq,skv", [(129, 193), (193, 65), (4097, 129), (65, 4097)])
def test_k2_reads_and_writes_nothing_across_a_head(sq, skv):
    """int8 codes carry no NaN, so head 1 is poisoned by K codes of 127 and
    a NaN V: a K or V tile read past the end of head 0, or a Q tile's store
    past its end, would carry NaN into heads 0 or 2 or their values into
    head 1, whose output must stay all NaN."""
    dev = _card()
    q = _randn((1, 3, sq, 64), 53, dev)
    k = _randn((1, 3, skv, 64), 54, dev)
    v = _randn((1, 3, skv, 64), 55, dev)
    q8, k8, factor = fa.quantize_qk_pair(q, k, 64 ** -0.5)
    k8[:, 1] = 127
    v[:, 1] = float("nan")
    out = fa.flash_qk8_launch(q8, k8, v, factor)
    torch.cuda.synchronize()
    ref = fa.flash_attention_qk8_plain(
        *(t[:, 0::2].contiguous() for t in (q8, k8, v)), factor)
    assert bool(torch.isfinite(out[:, 0::2]).all())
    _assert_within_bars(out[:, 0::2], ref)
    assert bool(torch.isnan(out[:, 1].float()).all())


@pytest.mark.cuda
def test_k2_wrapper_raises_on_what_the_kernel_does_not_take():
    dev = _card()
    q = _randn((1, 2, 64, 64), 9, dev)
    q8, k8, factor = fa.quantize_qk_pair(q, q, 0.125)
    before = fa.launches_qk8.count
    with pytest.raises(ValueError, match="16-byte aligned"):  # K2's TMA loads
        t = torch.empty(q8.numel() + 1, device=dev, dtype=q8.dtype)[1:].view(q8.shape)
        fa.flash_qk8_launch(t, k8, q, factor)
    with pytest.raises(ValueError, match="fp32"):
        fa.flash_qk8_launch(q8, k8, q, factor.double())
    with pytest.raises(ValueError, match="int8"):
        fa.flash_qk8_launch(q, k8, q, factor)
    assert fa.launches_qk8.count == before


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [5, 333])
def test_qlinear_on_card_matches_cpu(rows):
    """QLinear on the card (torch._int_mm, padded below 17 rows) against the
    same module on the CPU: equal int8 codes, exactly equal int32
    accumulators, and outputs equal to fp32 rounding of the epilogue."""
    dev = _card()
    lin = torch.nn.Linear(72, 40)
    mod = quant.QLinear.from_linear(lin)
    x = torch.randn(2, rows, 72)
    x_q, s_x = quant.dynamic_quant_rows(x.reshape(-1, 72))
    x_q_card, s_x_card = quant.dynamic_quant_rows(x.reshape(-1, 72).to(dev))
    assert torch.equal(x_q_card.cpu(), x_q) and torch.equal(s_x_card.cpu(), s_x)
    acc = quant.int8_matmul(x_q, mod.weight_q)
    acc_card = quant.int8_matmul(x_q_card, mod.weight_q.to(dev))
    assert torch.equal(acc_card.cpu(), acc)
    torch.testing.assert_close(mod.to(dev)(x.to(dev)).cpu(), mod.cpu()(x),
                               rtol=1e-6, atol=1e-6)


# K4 and K5 (csrc/conv3d_taps_sm90.cu): (B, Fo, Ho, Wo, Cin, Cout, kt)
CONV_CASES = [
    (1, 2, 16, 32, 128, 128, 3),  # whole 8x16 tiles
    (2, 1, 13, 21, 256, 128, 3),  # ragged rows and columns, Fo = 1, a batch
    (1, 3, 9, 40, 64, 256, 3),  # one 64-channel slab, two cout blocks
    (2, 3, 11, 19, 128, 128, 1),  # the per-frame 3x3 conv
]


def _conv_case(case, seed, dev, int8: bool):
    B, Fo, Ho, Wo, cin, cout, kt = case
    gen = torch.Generator(device=dev).manual_seed(seed)
    shape_x = (B, Fo + kt - 1, Ho + 2, Wo + 2, cin)
    shape_w = (kt * 9, cout, cin)
    if int8:
        x = torch.randint(-127, 128, shape_x, generator=gen, device=dev).to(torch.int8)
        w = torch.randint(-127, 128, shape_w, generator=gen, device=dev).to(torch.int8)
        scale = torch.rand(cout, generator=gen, device=dev) * 1e-4
        return x, w, scale
    x = torch.randn(shape_x, generator=gen, device=dev, dtype=torch.bfloat16)
    w = (torch.randn(shape_w, generator=gen, device=dev) * 0.03).to(torch.bfloat16)
    return x, w, None


@pytest.mark.cuda
@pytest.mark.parametrize("case", CONV_CASES)
@pytest.mark.parametrize("channels_first", [False, True])
def test_k4_equals_plain_on_card(case, channels_first):
    """K4 is exact: int32 sums, one fp32 multiply, one rounding."""
    dev = _card()
    x, w, scale = _conv_case(case, 1, dev, int8=True)
    counter = tconv.launches_w8a8 if case[-1] == 3 else tconv.launches_w8a8_kt1
    for out_dtype in (torch.float32, torch.bfloat16):
        before = counter.count
        out = tconv.conv_taps(x, w, scale, case[-1], out_dtype, channels_first)
        torch.cuda.synchronize()
        assert counter.count == before + 1
        ref = tconv.conv_taps_plain(x, w, scale, case[-1], out_dtype, channels_first)
        assert out.shape == ref.shape and out.dtype == out_dtype
        assert out.is_contiguous()
        assert torch.equal(out, ref)
    short = tconv.conv_taps_plain(x, w, scale, case[-1], torch.float32,
                                  channels_first, skip_tap=4)
    assert not torch.equal(out.float(), short)  # the comparison can fail
    # the VAE's form: the offset term by border class and the bias, added in
    # the epilogue in the plain version's order
    B, Fo, Ho, Wo, cin, cout, kt = case
    gen = torch.Generator(device=dev).manual_seed(7)
    addend = torch.randn((cout, min(Ho, 3), min(Wo, 3)), generator=gen, device=dev)
    bias = torch.randn(cout, generator=gen, device=dev)
    for out_dtype in (torch.float32, torch.bfloat16):
        out = tconv.conv_taps(x, w, scale * 1e3, kt, out_dtype, channels_first,
                              addend=addend, bias=bias)
        ref = tconv.conv_taps_plain(x, w, scale * 1e3, kt, out_dtype, channels_first,
                                    addend=addend, bias=bias)
        assert torch.equal(out, ref)
    bare = tconv.conv_taps_plain(x, w, scale * 1e3, kt, torch.float32, channels_first)
    assert not torch.equal(out.float(), bare)


@pytest.mark.cuda
@pytest.mark.parametrize("case", CONV_CASES[:3])
def test_k5_within_bars_on_card(case):
    """K5 sums fp32 products in another order than its plain version: fp32
    out within 2e-5 of the largest output (tests/test_conv_kernel.py), bf16
    out within one bf16 ulp of the plain bf16 result (plus that fp32 slack,
    which is all that separates two outputs near zero)."""
    dev = _card()
    x, w, _ = _conv_case(case, 2, dev, int8=False)
    before = tconv.launches_bf16.count
    out = tconv.conv_taps(x, w, None, 3, torch.float32, channels_first=True)
    out_bf = tconv.conv_taps(x, w, None, 3, torch.bfloat16)
    torch.cuda.synchronize()
    assert tconv.launches_bf16.count == before + 2
    ref = tconv.conv_taps_plain(x, w, None, 3, torch.float32, channels_first=True)
    ref_bf = tconv.conv_taps_plain(x, w, None, 3, torch.bfloat16)
    slack = 2e-5 * float(ref.abs().max())
    assert float((out - ref).abs().max()) <= slack
    _, exponent = torch.frexp(ref_bf.float().abs())
    ulp = torch.ldexp(torch.ones_like(ref_bf, dtype=torch.float32), exponent - 8)
    assert bool(((out_bf.float() - ref_bf.float()).abs() <= ulp + slack).all())
    jax_form = tconv.conv3d_bf16(x[0].float(), w.view(3, 3, 3, *w.shape[1:])
                                 .permute(0, 1, 2, 4, 3).float(), torch.float32)
    assert torch.equal(jax_form, out[0].permute(1, 2, 3, 0))


# Around the kernel's tiles (384 flat positions q = f * Hp * Wp + h * Wp + w,
# in 64-row blocks): heights and widths at the block and tile edges, then
# two windows, Cin 64 to 512, Cout 256 and k_t = 1.
CONV_RAGGED_HW = (1, 63, 64, 65, 127, 128, 129, 383, 384, 385)
CONV_RAGGED = [(1, 1, h, w, 64, 128, 3) for h in CONV_RAGGED_HW for w in CONV_RAGGED_HW] + [
    (2, 2, 65, 129, 128, 256, 3),
    (2, 1, 63, 385, 256, 128, 1),
    (1, 3, 127, 64, 512, 128, 3),
    (2, 1, 1, 383, 64, 256, 1),
    (1, 2, 384, 1, 128, 128, 3),
]


def _k5_bar(ref: torch.Tensor, kt: int, cin: int) -> float:
    """2e-5 of the largest output (tests/test_conv_kernel.py), times the
    square root of a sum longer than 27 x 256 products."""
    return 2e-5 * max(1.0, (kt * 9 * cin / (27 * 256)) ** 0.5) * float(ref.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("case", CONV_RAGGED)
def test_conv_kernels_at_ragged_shapes_on_card(case):
    """K4 equal to its plain version in its three output forms (the VAE's
    NCDHW with offset term and bias, fp32 NCDHW, bf16 NDHWC), K5 within its
    bars, at every shape of the sweep."""
    dev = _card()
    B, Fo, Ho, Wo, cin, cout, kt = case
    x, w, scale = _conv_case(case, 11, dev, int8=True)
    gen = torch.Generator(device=dev).manual_seed(12)
    addend = torch.randn((cout, min(Ho, 3), min(Wo, 3)), generator=gen, device=dev)
    bias = torch.randn(cout, generator=gen, device=dev)
    out = tconv.conv_taps(x, w, scale * 1e3, kt, torch.bfloat16, True, addend=addend,
                          bias=bias)
    out_f32 = tconv.conv_taps(x, w, scale, kt, torch.float32, channels_first=True)
    out_bf = tconv.conv_taps(x, w, scale, kt, torch.bfloat16)
    torch.cuda.synchronize()
    assert torch.equal(out, tconv.conv_taps_plain(x, w, scale * 1e3, kt, torch.bfloat16,
                                                  True, addend=addend, bias=bias))
    ref = tconv.conv_taps_plain(x, w, scale, kt, torch.float32, channels_first=True)
    assert torch.equal(out_f32, ref)
    assert torch.equal(out_bf.permute(0, 4, 1, 2, 3), ref.to(torch.bfloat16))
    assert not torch.equal(ref, tconv.conv_taps_plain(x, w, scale, kt, torch.float32, True,
                                                      skip_tap=kt * 9 - 1))
    x, w, _ = _conv_case(case, 13, dev, int8=False)
    out = tconv.conv_taps(x, w, None, kt, torch.float32, channels_first=True)
    torch.cuda.synchronize()
    ref = tconv.conv_taps_plain(x, w, None, kt, torch.float32, channels_first=True)
    bar = _k5_bar(ref, kt, cin)
    assert float((out - ref).abs().max()) <= bar
    short = tconv.conv_taps_plain(x, w, None, kt, torch.float32, True, skip_tap=kt * 9 - 1)
    assert float((short - ref).abs().max()) > bar  # the bar can fail


@pytest.mark.cuda
@pytest.mark.parametrize("kt", [3, 1])
@pytest.mark.parametrize("window,frames", [(0, slice(None)), (1, slice(-1, None))])
def test_k5_stores_nothing_it_read_across_a_window_or_frame(kt, window, frames):
    """Tiles run across frames and windows and compute positions they never
    store. With NaN in all of one window, or in the last frame of the other,
    every output whose taps read no NaN is finite and within K5's bars of
    its plain version."""
    dev = _card()
    case = (2, 3, 37, 53, 128, 128, kt)
    x, w, _ = _conv_case(case, 14, dev, int8=False)
    x[window, frames] = float("nan")
    out = tconv.conv_taps(x, w, None, kt, torch.float32, channels_first=True)
    torch.cuda.synchronize()
    ref = tconv.conv_taps_plain(x, w, None, kt, torch.float32, channels_first=True)
    clean = torch.isfinite(ref)
    B, Fo, Ho, Wo, _, cout, _ = case
    per_frame = Ho * Wo * cout
    assert int(clean.sum()) == Fo * per_frame + (0 if window == 0 else (Fo - 1) * per_frame)
    assert bool(torch.isfinite(out[clean]).all())
    assert float((out[clean] - ref[clean]).abs().max()) <= _k5_bar(ref[clean], kt, 128)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("with_eq", [False, True])
@pytest.mark.parametrize("shape,padding", [((2, 68, 3, 13, 37), 1),  # ragged tiles
                                           ((1, 256, 2, 9, 70), 0),
                                           ((1, 128, 4, 40, 64), 1)])
def test_quantize_pack_equals_plain_on_card(shape, padding, with_eq, dtype):
    """The quantizer's kernel against its plain version on the card: the
    same rounded fp32 steps (one fused multiply-add with an equalization
    vector), so the codes are equal, the zero border included."""
    dev = _card()
    gen = torch.Generator(device=dev).manual_seed(sum(shape))
    x = (torch.randn(shape, generator=gen, device=dev) * 3).to(dtype)
    eq = torch.rand(shape[1], generator=gen, device=dev) + 0.5 if with_eq else None
    s, m = quant.asym_grid(x, eq_inv=eq, channel_dim=1)
    before = tconv.launches_quantize.count
    out = tconv.quantize_pack(x, s, m, eq, padding)
    torch.cuda.synchronize()
    assert tconv.launches_quantize.count == before + 1
    ref = tconv.quantize_pack_plain(x, s, m, eq, padding)
    B, C, Ft, H, W = shape
    assert out.shape == ref.shape == (B, Ft, H + 2 * padding, W + 2 * padding, C)
    assert out.dtype == torch.int8 and out.is_contiguous()
    assert torch.equal(out, ref)
    assert int(out.abs().max()) == 127  # the grid is used up to its edge
    if padding:
        assert not out[:, :, 0].any() and not out[:, :, :, -1].any()
    # a transposed input is copied, not misread
    xt = x.transpose(3, 4).contiguous().transpose(3, 4)
    assert torch.equal(tconv.quantize_pack(xt, s, m, eq, padding), ref)
    with pytest.raises(ValueError, match="C % 4"):
        tconv.quantize_pack(x[:, :3], s, m, None, padding)


@pytest.mark.cuda
def test_conv_wrapper_raises_on_what_the_kernel_does_not_take():
    dev = _card()
    x, w, scale = _conv_case((1, 1, 4, 4, 64, 64, 3), 3, dev, int8=True)
    before = tconv.launches_w8a8.count
    with pytest.raises(ValueError, match="Cout % 128"):  # 64 output channels
        tconv.conv_taps(x, w, scale, 3)
    x, w, scale = _conv_case((1, 1, 4, 4, 64, 128, 3), 3, dev, int8=True)
    with pytest.raises(ValueError, match="scale"):
        tconv.conv_taps(x, w, scale.double(), 3)
    with pytest.raises(ValueError, match="contiguous"):
        tconv.conv_taps(x.transpose(2, 3), w, scale, 3)
    with pytest.raises(ValueError, match="of one type"):
        tconv.conv_taps(x.float(), w.float(), None, 3)
    assert tconv.launches_w8a8.count == before
    # the plain version takes them on request, and a QConv3d never drops to a
    # float conv: its unsupported channel count raises on the card
    conv = quant.quantize_conv(torch.nn.Conv3d(64, 64, 3), with_ksum=True).to(dev)
    with pytest.raises(ValueError, match="Cout % 128"):
        quant.qconv(conv, torch.randn(1, 64, 3, 4, 4, device=dev))


@pytest.mark.cuda
@pytest.mark.parametrize("stride", [1, 2])
def test_qconv_on_card_matches_cpu(stride):
    """A quantized conv on the card (K4, or the int8 matrix product of the
    stride-2 form) against the same module on the CPU (the plain version):
    the same codes and int32 sums, so equal up to the range search's fp32
    summation order (the chosen grid is compared first)."""
    dev = _card()
    torch.manual_seed(4)
    kt = 3 if stride == 1 else 1
    float_conv = (torch.nn.Conv3d(128, 128, 3) if kt == 3 else torch.nn.Conv2d(128, 128, 3))
    conv = quant.quantize_conv(float_conv, with_ksum=True,
                               calib_amax=torch.rand(128) + 0.5)
    x = torch.nn.functional.silu(torch.randn(1, 128, kt + 1, 12, 14) * 2)
    grid_cpu = quant.asym_grid(x, eq_inv=conv.equalize_inv, channel_dim=1)
    grid_card = quant.asym_grid(x.to(dev), eq_inv=conv.equalize_inv.to(dev), channel_dim=1)
    assert all(torch.equal(a, b.cpu()) for a, b in zip(grid_cpu, grid_card))
    ref = quant.qconv(conv, x, stride, 2 - stride)
    out = quant.qconv(conv.to(dev), x.to(dev), stride, 2 - stride)
    assert out.shape == ref.shape
    torch.testing.assert_close(out.cpu(), ref, rtol=1e-6, atol=1e-6)


@pytest.mark.cuda
def test_torch_stitcher_on_card_equals_numpy():
    """The fused path's stitcher on the card against the NumPy one: the same
    plan's tiles (each shifted by its own offset), bit for bit, and the same
    refusal of a pixel written twice."""
    import numpy as np

    from dove_tpu_torch import tiling

    dev = _card()
    args = (33, 192, 320, 16, (128, 128), 8, (32, 32))
    tiles = tiling.plan_tiles(*args)
    video = np.random.default_rng(0).standard_normal((3, 33, 192, 320)).astype(np.float32)
    ref = tiling.Stitcher(3, 33, 192, 320, 8, (32, 32))
    ours = tiling.TorchStitcher(3, 33, 192, 320, 8, (32, 32), device=dev)
    for i, t in enumerate(tiles):
        d = video[:, t.t_start:t.t_end, t.h_start:t.h_end, t.w_start:t.w_end] + i
        ref.add(t, d)
        ours.add(t, torch.from_numpy(d).to(dev))
    out = ours.finalize()
    assert out.device.type == "cuda"
    assert np.array_equal(out.cpu().numpy(), ref.finalize())
    ours.add(tiles[0], torch.zeros((3,) + tiles[0].shape, device=dev))
    with pytest.raises(RuntimeError, match="more than once"):
        ours.finalize()


@pytest.mark.cuda
def test_fused_pass_at_a_short_tile_launches_k1():
    """The fused path on a tile whose DiT pass is far under 2048 tokens takes
    K1 (the automatic rule would take the naive attention), one launch a
    layer a call, and agrees with attention_backend="plain" (PSNR >= 40 dB
    on 8-bit output, chip_smoke.py's bar)."""
    import dataclasses

    import numpy as np

    from dove_tpu_torch import init_dit_params, init_vae_params, tiny_test
    from dove_tpu_torch.pipeline import DovePipeline

    dev = _card()
    base = tiny_test()
    cfg = dataclasses.replace(base, dit=dataclasses.replace(
        base.dit, num_attention_heads=2, attention_head_dim=64))
    dit = init_dit_params(cfg.dit, 0, dev, torch.bfloat16)
    vae = init_vae_params(cfg.vae, 1, dev, torch.bfloat16)
    prompt = torch.zeros((cfg.dit.max_text_seq_length, cfg.dit.text_embed_dim))
    clip = np.random.default_rng(1).uniform(0, 1, (9, 16, 32, 3)).astype(np.float32)
    outs = {}
    for backend in (None, "plain"):
        pipe = DovePipeline(config=cfg, dit=dit, vae=vae, prompt_embedding=prompt,
                            dtype=torch.bfloat16, device=dev, attention_backend=backend,
                            sample_posterior=False)
        before = fa.launches.count
        outs[backend] = pipe.process_frames(clip, tile_size_hw=(64, 64), tile_batch=2)
        outs[backend, "k1"] = fa.launches.count - before
    # three 64x64 tiles of 9 frames: two calls (2 + 1 padded to 2)
    assert outs[None, "k1"] == cfg.dit.num_layers * 2
    assert outs["plain", "k1"] == 0
    a, b = (np.round(outs[k] * 255.0) for k in (None, "plain"))
    mse = float(np.mean((a - b) ** 2))
    assert mse == 0 or 10 * np.log10(255.0**2 / mse) >= 40.0


@pytest.mark.cuda
def test_fit_one_step_on_card(tmp_path, monkeypatch):
    """Trainer.fit for one stage-1 step at full width and 2 DiT layers on
    the card: a dataset whose clips are made in memory (a subclass's
    read_clip: the card decodes no video file), configs/degradation.yaml
    with mpeg4's codec share on libx264 and h264 (mpeg4 needs OpenCV),
    loaded in this process. The step's loss is finite and logged, and it
    ran through K1-lse (twice a layer under checkpointing), K3a and K3b."""
    import dataclasses
    import json
    from pathlib import Path

    import torch.nn.functional as F

    from dove_tpu_torch import cogvideox1_5_5b
    from dove_tpu_torch.data import datasets
    from dove_tpu_torch.train.args import Args
    from dove_tpu_torch.train.trainer import DOVES1Trainer

    dev = _card()

    class MemoryClips(datasets.RealSRDataset):
        def read_clip(self, path, max_frames):
            gen = torch.Generator().manual_seed(int(Path(path).stem[-1]))
            coarse = torch.rand((1, 3, 4, 6, 10), generator=gen)
            clip = F.interpolate(coarse, size=(max_frames, 96, 192), mode="trilinear")
            return clip[0].permute(1, 2, 3, 0).contiguous()

    monkeypatch.setattr(datasets, "RealSRDataset", MemoryClips)
    for i in range(2):
        (tmp_path / f"clip{i}.mp4").touch()
    (tmp_path / "videos.txt").write_text("clip0.mp4\nclip1.mp4\n")
    repo = Path(__file__).resolve().parents[1]
    text = (repo / "configs" / "degradation.yaml").read_text()
    (tmp_path / "deg.yaml").write_text(text.replace(
        "codec_prob: [0.3333, 0.3333, 0.3334]", "codec_prob: [0.5, 0.5, 0.0]"))
    base = cogvideox1_5_5b()
    cfg = dataclasses.replace(base, dit=dataclasses.replace(base.dit, num_layers=2))
    args = Args(model_path=tmp_path / "none", output_dir=tmp_path / "out",
                data_root=tmp_path, video_column=tmp_path / "videos.txt",
                degradation_config=str(tmp_path / "deg.yaml"),
                train_resolution=(5, 64, 128), batch_size=2, train_steps=1,
                mixed_precision="bf16", gradient_checkpointing=True, num_workers=0,
                rank=16, lora_alpha=8)
    counters = (fa.launches_lse, fa.launches_bwd_dq, fa.launches_bwd_dkv)
    before = [c.count for c in counters]
    tr = DOVES1Trainer(args, pipeline_config=cfg, device=dev)
    tr.fit()
    assert [c.count - b for c, b in zip(counters, before)] == [4, 2, 2]
    log = [json.loads(x) for x in (tmp_path / "out" / "train_log.jsonl")
           .read_text().splitlines()]
    assert "video_compression_backend" in log[0]
    step = [r for r in log if "loss" in r]
    assert [r["step"] for r in step] == [1] and math.isfinite(step[0]["loss"])
    assert (tmp_path / "out" / "checkpoint-1").is_dir()


@pytest.mark.cuda
def test_device_spans_time_the_stream_without_waiting():
    """A span around queued matrix products returns long before they finish
    (no span waits for the device), and reads their device time, as a pair
    of events around the same work does; a nested span reads its half. A
    second unit reuses the first one's events."""
    dev = _card()
    a = _randn((8192, 8192), 1, dev)
    (a @ a).sum().item()
    ref = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    ref[0].record()
    for _ in range(20):
        a @ a
    ref[1].record()
    ref[1].synchronize()
    want = ref[0].elapsed_time(ref[1]) / 1e3
    pools = []
    for _ in range(2):
        with obs.unit(dev) as u:
            t0 = time.perf_counter()
            with obs.span("work"):
                with obs.span("work.half"):
                    for _ in range(10):
                        a @ a
                for _ in range(10):
                    a @ a
            host = time.perf_counter() - t0
            with obs.span("host", host=True):
                pass
        pools.append({id(e) for e in obs._free_events[torch.cuda.current_device()]})
        assert host < 0.5 * u.times["work"]
        assert u.times["work"] == pytest.approx(want, rel=0.2)
        assert u.times["work.half"] == pytest.approx(want / 2, rel=0.2)
        assert set(u.times) == {"work", "work.half", "host"}
    assert pools[0] == pools[1] and len(pools[0]) >= 4
