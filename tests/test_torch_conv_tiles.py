"""The tiling plan of the port's tap convolution kernel (K4 and K5,
``csrc/conv3d_taps_sm90.cu``), checked on the CPU.

The kernel cannot run here, but its addressing is planned in
``dove_tpu_torch/ops/conv3d_int8.py`` (``tile_count``, ``halo_boxes``,
``tap_row``, ``tile_stores``, ``weight_image``), and the wrapper holds the
built library's geometry to that plan. These tests run the plan as the kernel does: each
tile's halo boxes are cut out of the window's flat input rows (rows past the
window read as zeros, as TMA fills them), every tap of every 64-row block
multiplies the rows ``tap_row`` names, and each tile stores what
``tile_stores`` lets it. The result must be the convolution itself, every
output pixel stored exactly once, and no stored value may depend on a row
outside x.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from dove_tpu_torch.ops import conv3d_int8 as tconv
from torch_threads import two_torch_threads  # noqa: F401 (autouse)


def _reference(x: torch.Tensor, w: torch.Tensor, kt: int) -> torch.Tensor:
    """The VALID tap convolution in int64, tap by tap."""
    B, F, Hp, Wp, _ = x.shape
    Fo, Ho, Wo = F - kt + 1, Hp - 2, Wp - 2
    out = 0
    for tap in range(kt * 9):
        dt, dh, dw = tap // 9, tap // 3 % 3, tap % 3
        view = x[:, dt:dt + Fo, dh:dh + Ho, dw:dw + Wo]
        out = out + view @ w[tap].T
    return out


def _run_plan(x: torch.Tensor, w: torch.Tensor, kt: int):
    """The kernel's schedule in PyTorch: (output, store count per pixel)."""
    B, F, Hp, Wp, cin = x.shape
    Fo, Ho, Wo = F - kt + 1, Hp - 2, Wp - 2
    cout = w.shape[1]
    n_rows = F * Hp * Wp
    flat = x.reshape(B, n_rows, cin)
    out = torch.zeros(B, Fo, Ho, Wo, cout, dtype=torch.int64)
    stores = torch.zeros(B, Fo, Ho, Wo, dtype=torch.int64)
    box = torch.arange(tconv.BOX_ROWS)
    for b in range(B):
        for tile in range(tconv.tile_count(Fo, Ho, Wo)):
            pieces: dict = {}
            for dt, dh, first in tconv.halo_boxes(tile, kt, Ho, Wo):
                assert first >= 0
                rows = first + box
                inside = rows < n_rows  # TMA reads these; the rest are zeros
                data = torch.zeros(tconv.BOX_ROWS, cin, dtype=torch.int64)
                data[inside] = flat[b, rows[inside]]
                got = pieces.setdefault((dt, dh), ([], []))
                got[0].append(data)
                got[1].append(inside)
            acc = torch.zeros(tconv.TILE_M, cout, dtype=torch.int64)
            filled = torch.zeros(tconv.TILE_M, dtype=torch.bool)  # read a zero fill
            for (dt, dh), (parts, inside) in pieces.items():
                piece, inside = torch.cat(parts), torch.cat(inside)
                assert piece.shape[0] == tconv.PIECE_ROWS
                for dw in range(3):
                    for block in range(tconv.TILE_M // 64):
                        r0 = tconv.tap_row(block, dw)
                        assert r0 + 64 <= tconv.PIECE_ROWS
                        rows = slice(block * 64, block * 64 + 64)
                        acc[rows] += piece[r0:r0 + 64] @ w[dt * 9 + dh * 3 + dw].T
                        filled[rows] |= ~inside[r0:r0 + 64]
            rows, f, h, wv = tconv.tile_stores(tile, Fo, Ho, Wo)
            assert not filled[rows].any(), "a stored position read past the window"
            out[b, f, h, wv] = acc[rows]
            stores[b, f, h, wv] += 1
    return out, stores


# (B, Fo, Ho, Wo, k_t): widths and heights at 1, at the 64-row blocks and at
# the 256-position tile, frames and windows that tiles run across
TILE_CASES = [
    (2, 1, 1, 1, 3),
    (1, 1, 1, 1, 1),
    (2, 2, 1, 63, 3),
    (1, 3, 63, 1, 3),
    (2, 1, 5, 64, 1),
    (1, 2, 3, 65, 3),
    (1, 1, 2, 127, 3),
    (2, 2, 4, 128, 1),
    (1, 1, 2, 129, 3),
    (1, 2, 1, 254, 3),
    (2, 1, 1, 256, 1),
    (1, 1, 1, 257, 3),
    (1, 3, 9, 13, 3),
    (2, 2, 15, 14, 1),
]


@pytest.mark.parametrize("case", TILE_CASES)
def test_tile_plan_computes_the_conv_and_stores_each_pixel_once(case):
    B, Fo, Ho, Wo, kt = case
    rng = np.random.default_rng(sum(case))
    x = torch.from_numpy(rng.integers(-127, 128, (B, Fo + kt - 1, Ho + 2, Wo + 2, 4)))
    w = torch.from_numpy(rng.integers(-127, 128, (kt * 9, 3, 4)))
    out, stores = _run_plan(x, w, kt)
    assert bool((stores == 1).all()), "a pixel stored never or twice"
    assert torch.equal(out, _reference(x, w, kt))


def test_tile_plan_covers_the_decode_shapes():
    """At the int8 decode plan's shapes (chip_smoke.py's CONV_SHAPES), the
    tiles cover the last stored position, waste under 2% of the positions
    they compute on the main shape, and every box starts inside x."""
    for Fo, Ho, Wo in ((33, 272, 336), (33, 136, 168), (17, 68, 84), (9, 34, 42)):
        tiles = tconv.tile_count(Fo, Ho, Wo)
        assert (tiles - 1) * tconv.TILE_M < tconv.flat_positions(Fo, Ho, Wo)
        assert tiles * tconv.TILE_M >= tconv.flat_positions(Fo, Ho, Wo)
        rows = (Fo + 2) * (Ho + 2) * (Wo + 2)
        assert all(0 <= first < rows for _, _, first in
                   tconv.halo_boxes(tiles // 2, 3, Ho, Wo))
    waste = 1 - 33 * 272 * 336 / (tconv.tile_count(33, 272, 336) * tconv.TILE_M)
    assert 0 < waste < 0.02


@pytest.mark.parametrize("dtype,kt,cout,cin", [(torch.int8, 3, 256, 64),
                                              (torch.bfloat16, 1, 128, 128)])
def test_weight_image_is_the_kernels_shared_memory_layout(dtype, kt, cout, cin):
    """Byte (cout block n, k_t, slab s, tap, cout row r, byte b of the slab)
    sits at block ((n * kt + k_t) * slabs + s) * 9 * 128 * 32, tap * 4096 +
    r * 32 + (b XOR 16 in rows 4-7 of every 8): TMA's 32-byte swizzle."""
    gen = torch.Generator().manual_seed(cout + cin)
    w = torch.randn((kt * 9, cout, cin), generator=gen).mul(40).to(dtype)
    raw = w.view(torch.uint8)
    img = tconv.weight_image(w)
    assert img.dtype == torch.uint8 and img.numel() == raw.numel()
    slabs = raw.shape[-1] // tconv.SLAB_BYTES
    n, k, s, tap, r, b = np.meshgrid(
        np.arange(cout // 128), np.arange(kt), np.arange(slabs), np.arange(9),
        np.arange(128), np.arange(32), indexing="ij")
    phys = b ^ (((r >> 2) & 1) << 4)
    off = ((((n * kt + k) * slabs + s) * 9 + tap) * 128 + r) * 32 + phys
    want = raw[torch.from_numpy((k * 9 + tap).ravel()),
               torch.from_numpy((n * 128 + r).ravel()),
               torch.from_numpy((s * 32 + b).ravel())]
    assert torch.equal(img[torch.from_numpy(off.ravel())], want)
