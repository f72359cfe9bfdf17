"""The port's CAME, Prodigy and 8- and 4-bit AdamW against the JAX package's
``make_optimizer`` (optax), fp32 on the CPU.

Six steps on one set of seeded leaves: ndim 1, 2 and 3 (a stacked ``[L,
...]`` leaf), sizes that neither block size (128, 2048) divides, and a leaf
whose gradient is always zero (CAME's factored rsqrt must keep it finite).
The gradients pull the parameters toward a seeded target (so Prodigy's
distance estimate grows) plus noise, growing so that the global-norm clip
acts on some steps and not on others. Both sides take the same gradients.

Bars: parameters within 1e-6 of the leaf's largest value (1e-5 for CAME and
Prodigy, whose factored statistics and inner products sum in another order);
the low-bit codes equal, except where the value before rounding lies within
1e-6 (of the code spacing) of a tie between two codes, at most 1e-4 of the
entries, and in blocks whose scale is 0: there the JAX package's 1e-38
floor is flushed to zero by XLA, 0 / 0 picks code 0, while the port keeps
the floor and writes the zero code; both decode to 0.
"""

from __future__ import annotations

import io

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from dove_tpu.train import optim as joptim
from dove_tpu_torch.train import checkpointing as tckpt
from dove_tpu_torch.train import optim as toptim
from torch_threads import two_torch_threads  # noqa: F401 (autouse)

SHAPES = [(7,), (37, 53), (3, 19, 41), (5, 9)]  # the last leaf's gradient is 0
STEPS = 6
KW = dict(betas=(0.9, 0.95), eps=1e-8, weight_decay=0.05, max_grad_norm=100.0)
PARAM_TOL = {"came": 1e-5, "prodigy": 1e-5}  # else 1e-6
TIE_TOL = 1e-6
MAX_TIE_SHARE = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """This file's small torch work in one thread: beside the suite's other
    workers a full thread pool oversubscribes the cores (the int8 VAE
    modes' plain convolutions then ran tens of times slower)."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def _leaves(seed: int):
    rng = np.random.default_rng(seed)
    params = [rng.standard_normal(s).astype(np.float32) for s in SHAPES]
    target = [rng.standard_normal(s).astype(np.float32) for s in SHAPES]
    noise = [[rng.standard_normal(s).astype(np.float32) for s in SHAPES]
             for _ in range(STEPS)]
    return params, target, noise


def _grads(params, target, noise, step: int) -> list[np.ndarray]:
    scale = 0.5 + 0.5 * step
    out = [scale * (np.asarray(p) - t) + 0.3 * n
           for p, t, n in zip(params, target, noise[step])]
    out[-1] = np.zeros_like(out[-1])
    return [x.astype(np.float32) for x in out]


def _schedules(name: str):
    # Prodigy's learning rate is a multiplier of its own estimate, 1 at base;
    # a warmup's first rate of 0 makes both packages' estimate 0 / 0 (below)
    if name == "prodigy":
        return joptim.make_lr_schedule(1.0), toptim.make_lr_schedule(1.0)
    return (joptim.make_lr_schedule(1e-2, warmup_steps=2),
            toptim.make_lr_schedule(1e-2, warmup_steps=2))


def _codebook(name: str, key: str):
    if "4bit" in name:
        return joptim._CB4_SIGNED if key == "m_q" else joptim._CB4_UNSIGNED
    return None


def _unpack(q: np.ndarray, name: str) -> np.ndarray:
    if "4bit" not in name:
        return q.astype(np.int64)
    return np.stack([q & 0xF, q >> 4], axis=-1).reshape(q.shape[0], -1).astype(np.int64)


def _pre_round(opt, grads: list[np.ndarray], max_norm=KW["max_grad_norm"]) -> dict:
    """The values the port's next step will encode, in float64 from its
    state before the step: m and sqrt(v) after the moment updates, on the
    gradients clipped to ``max_norm`` (None: no clip), flat per leaf and
    padded to whole blocks."""
    norm = np.sqrt(sum(np.square(g.astype(np.float64)).sum() for g in grads))
    factor = max_norm / norm if max_norm is not None and norm >= max_norm else 1.0
    b1, b2 = KW["betas"]
    out = {"m_q": [], "v_q": []}
    for i, g in enumerate(grads):
        n = opt.m_scale[i].numel() * opt.codes.block_size
        shape = (n,)
        m = opt._decode(opt.m_q[i], opt.m_scale[i], shape, True).double().numpy()
        v = opt._decode(opt.v_q[i], opt.v_scale[i], shape, False).double().numpy() ** 2
        gf = np.zeros(n)
        gf[:g.size] = g.ravel() * factor
        out["m_q"].append((b1 * m + (1 - b1) * gf).reshape(-1, opt.codes.block_size))
        out["v_q"].append(np.sqrt(b2 * v + (1 - b2) * gf * gf)
                          .reshape(-1, opt.codes.block_size))
    return out


def _near_tie(norm: np.ndarray, book) -> np.ndarray:
    """Whether a normalized value lies within TIE_TOL of a tie between two
    codes, in units of the code spacing (linear codes: a half-integer)."""
    if book is None:
        return np.abs(np.abs(norm - np.floor(norm)) - 0.5) <= TIE_TOL
    book = np.asarray(book, np.float64)
    d = np.sort(np.abs(norm[..., None] - book), axis=-1)
    return (d[..., 1] - d[..., 0]) <= TIE_TOL * np.abs(np.diff(book)).min()


def _check_codes(name: str, ours: dict, ref, pre: dict) -> int:
    """Hold the port's codes to JAX's; returns how many differ near a tie."""
    ties = total = 0
    for key, scale_key in (("m_q", "m_scale"), ("v_q", "v_scale")):
        for i, (q_t, q_j, s_j) in enumerate(zip(ours[key], getattr(ref, key),
                                                getattr(ref, scale_key))):
            s_j = np.asarray(s_j)
            s_t = ours[scale_key][i].numpy()
            np.testing.assert_allclose(s_t, s_j, rtol=1e-6)
            c_t, c_j = _unpack(q_t.numpy(), name), _unpack(np.asarray(q_j), name)
            live = s_j > 0
            total += c_t[live].size
            diff = (c_t != c_j) & live[:, None]
            if diff.any():
                # the linear codes divide by amax / 127 (or max / 255), the
                # 4-bit ones by the absmax itself: the stored scale either way
                norm = pre[key][i] / np.where(live, s_j, 1.0)[:, None]
                near = _near_tie(norm, _codebook(name, key))
                assert near[diff].all(), f"{key}[{i}]: codes differ away from a tie"
                ties += int(diff.sum())
            assert not s_t[~live].any()  # a zero-scale block decodes to 0 both sides
    assert ties <= MAX_TIE_SHARE * total, (ties, total)
    return ties


@pytest.mark.parametrize("name", ["came", "prodigy", "adamw-8bit", "adam-8bit",
                                  "adamw-4bit", "adam-4bit"])
def test_optimizer_matches_optax(name):
    params, target, noise = _leaves(11)
    sched_j, sched_t = _schedules(name)
    opt_j = joptim.make_optimizer(name, sched_j, **KW)
    p_j = [jnp.asarray(p) for p in params]
    state_j = opt_j.init(p_j)
    opt = toptim.make_optimizer(name, sched_t, **KW)
    p_t = [torch.from_numpy(p.copy()) for p in params]
    opt.init(p_t)
    tol = PARAM_TOL.get(name, 1e-6)
    clipped = []
    for step in range(STEPS):
        g = _grads(p_j, target, noise, step)
        g_j = [jnp.asarray(x) for x in g]
        pre = _pre_round(opt, g) if "bit" in name else None
        upd, state_j = opt_j.update(g_j, state_j, p_j)
        p_j = optax.apply_updates(p_j, upd)
        norm = opt.step(p_t, [torch.from_numpy(x) for x in g])
        np.testing.assert_allclose(float(norm), float(optax.global_norm(g_j)), rtol=1e-6)
        clipped.append(float(norm) >= KW["max_grad_norm"])
        for ours, ref in zip(p_t, p_j):
            ref = np.asarray(ref)
            assert np.isfinite(ours.numpy()).all()
            err = np.abs(ours.numpy() - ref).max() / np.abs(ref).max()
            assert err <= tol, (name, step, err)
        if pre is not None:
            _check_codes(name, opt.state_dict(), state_j[1], pre)
    assert any(clipped) and not all(clipped)
    assert opt.count == STEPS
    if name == "prodigy":  # the distance estimate grew, the same on both sides
        d_j = float(state_j[1].estim_lr)
        assert d_j > 1e-6
        np.testing.assert_allclose(float(opt.estim_lr), d_j, rtol=1e-5)
    if name == "came":  # the zero-gradient leaf moves by the decay alone
        decay = np.prod([1.0 - KW["weight_decay"] * sched_j(k) for k in range(STEPS)])
        np.testing.assert_allclose(p_t[-1].numpy(), params[-1] * decay, rtol=1e-6)


def test_prodigy_warmup_start_is_nan_in_both_packages():
    """A warmup's first learning rate is 0: Prodigy's weighted gradient sum is
    then 0, its estimate 0 / 0, and every parameter NaN after the first
    step, in optax and in the port alike (reproduced for parity)."""
    params, target, noise = _leaves(5)
    sched_j = joptim.make_lr_schedule(1e-2, warmup_steps=2)
    opt_j = joptim.make_optimizer("prodigy", sched_j, **KW)
    p_j = [jnp.asarray(p) for p in params]
    upd, _ = opt_j.update([jnp.asarray(g) for g in _grads(p_j, target, noise, 0)],
                          opt_j.init(p_j), p_j)
    p_j = optax.apply_updates(p_j, upd)
    opt = toptim.make_optimizer("prodigy", toptim.make_lr_schedule(1e-2, warmup_steps=2),
                                **KW)
    p_t = [torch.from_numpy(p.copy()) for p in params]
    opt.init(p_t)
    opt.step(p_t, [torch.from_numpy(g) for g in _grads(params, target, noise, 0)])
    for ours, ref in zip(p_t, p_j):
        assert np.isnan(np.asarray(ref)).all() and torch.isnan(ours).all()


def test_nearest_code_is_argmin_with_its_ties():
    """The codebook search against argmin |x - cb| (first of equal
    distances) on random values, every code, and the fp32 midpoints
    between neighbours and their next floats either side."""
    rng = np.random.default_rng(0)
    for book in (joptim._CB4_SIGNED, joptim._CB4_UNSIGNED):
        book = book.astype(np.float32)
        lo = float(book.min())
        mids = ((book[:-1] + book[1:]) / np.float32(2)).astype(np.float32)
        x = np.concatenate([
            rng.uniform(lo, 1.0, 20000).astype(np.float32), book, mids,
            np.nextafter(mids, np.float32(np.inf)), np.nextafter(mids, np.float32(-np.inf)),
        ]).astype(np.float32)
        want = np.argmin(np.abs(x[:, None] - book[None]), axis=-1)
        got = toptim.nearest_code(torch.from_numpy(x), torch.from_numpy(book))
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("name", ["came", "prodigy", "adamw-8bit", "adamw-4bit", "adamw"])
def test_state_dict_round_trips_through_a_checkpoint(name, tmp_path):
    """Three steps, a checkpoint, a fresh optimizer restored from it: the
    state bit for bit, and the next step equal to the uninterrupted one's."""
    params, target, noise = _leaves(2)
    sched = toptim.make_lr_schedule(1.0 if name == "prodigy" else 1e-2)
    p_a = [torch.from_numpy(p.copy()) for p in params]
    opt_a = toptim.make_optimizer(name, sched, **KW)
    opt_a.init(p_a)
    for step in range(3):
        opt_a.step(p_a, [torch.from_numpy(g) for g in _grads(p_a, target, noise, step)])
    path = tckpt.save_checkpoint(tmp_path, 3, {"opt_state": opt_a.state_dict()})
    p_b = [p.clone() for p in p_a]
    opt_b = toptim.make_optimizer(name, sched, **KW)
    opt_b.init([torch.from_numpy(p.copy()) for p in params])
    restored = tckpt.restore_checkpoint(path.parent / path.name,
                                        {"opt_state": opt_b.state_dict()})
    opt_b.load_state_dict(restored["opt_state"])
    _assert_same_state(opt_a.state_dict(), opt_b.state_dict())
    g = [torch.from_numpy(x) for x in _grads(p_a, target, noise, 3)]
    opt_a.step(p_a, g)
    opt_b.step(p_b, g)
    for a, b in zip(p_a, p_b):
        assert torch.equal(a, b)
    buf = io.BytesIO()
    torch.save(opt_a.state_dict(), buf)  # plain tensors and ints only
    assert opt_a.state_bytes() > 0


def _assert_same_state(a, b) -> None:
    assert type(a) is type(b) or (isinstance(a, (list, tuple)) and isinstance(b, (list, tuple)))
    if isinstance(a, dict):
        assert set(a) == set(b)
        for k in a:
            _assert_same_state(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _assert_same_state(x, y)
    elif isinstance(a, torch.Tensor):
        assert a.dtype == b.dtype and torch.equal(a, b)
    else:
        assert a == b


def test_state_bytes_of_the_low_bit_optimizers():
    """Two code streams and an fp32 scale per block: about 2 bytes a
    parameter at 8 bits and 1.06 at 4 (the JAX package's docstring says
    0.55, one stream's worth), against AdamW's 8 in fp32."""
    p = [torch.zeros(3, 4096), torch.zeros(1000)]
    n = sum(x.numel() for x in p)
    sizes = {}
    for name in ("adamw", "adamw-8bit", "adamw-4bit"):
        opt = toptim.make_optimizer(name, toptim.make_lr_schedule(1e-3))
        opt.init(p)
        sizes[name] = opt.state_bytes() / n
    assert sizes["adamw"] == 8.0
    assert 2.0 <= sizes["adamw-8bit"] < 2.5
    assert 1.0 <= sizes["adamw-4bit"] < 1.1
