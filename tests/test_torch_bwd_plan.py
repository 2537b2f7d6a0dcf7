"""The K3/K4 split plan (``repro_torch.kernels.lowrank_bwd.split_plan`` and
``split_rows``): how the sum over M of dU and dV is cut among CTAs; and
K2's phase-2 plan (``dx_plan`` and ``dx_tiles``): which output tiles of dx
each CTA of its persistent grid computes.  Plain Python, so it runs
without a card: the kernels cut M and walk dx exactly as ``split_rows``
and ``dx_tiles`` say, and the plans pick their numbers from the output's
shape and the card's SM count."""

import pytest
import torch

from repro_torch.kernels.lowrank_bwd import (BOX_M, DX_COLS, DX_ROWS, TILE_COLS, TILE_ROWS,
                                             dx_plan, dx_tiles, split_plan, split_rows)

torch.set_num_threads(1)

H100_SMS = 132
M_TRAIN = 2048  # 8 x 256 tokens a train step
# (rows, cols) of dU (C, r) and dV (r, S) at the Eq.-5 and Algorithm-1
# train shapes of smollm-360m: wq/wo, wk/wv, gate/up, down
TRAIN_OUT = sorted({out for c, r, s in [(960, 240, 960), (960, 120, 320), (960, 349, 2560),
                                        (2560, 349, 960), (960, 239, 960), (960, 80, 320),
                                        (960, 256, 2560), (2560, 256, 960)]
                    for out in ((c, r), (r, s))})
# (M, rows, cols, SMs) at the train shapes, then ragged M, tiny and huge
# outputs, and another card's SM count
CASES = ([(M_TRAIN, rows, cols, H100_SMS) for rows, cols in TRAIN_OUT]
         + [(1, 960, 240, H100_SMS), (8, 120, 320, H100_SMS), (1000, 33, 70, H100_SMS),
            (1000, 17, 70, H100_SMS), (300, 24, 80, H100_SMS), (129, 5, 33, H100_SMS),
            (100_000, 120, 320, H100_SMS), (2048, 4096, 4096, H100_SMS),
            (2048, 120, 320, 78)])


def _tiles(rows, cols):
    return -(-rows // TILE_ROWS) * -(-cols // TILE_COLS)


@pytest.mark.parametrize("m,rows,cols,sms", CASES)
def test_splits_partition_m_in_order(m, rows, cols, sms):
    splits = split_plan(m, rows, cols, sms)
    cuts = split_rows(m, splits)
    assert len(cuts) == splits >= 1
    assert cuts[0][0] == 0 and cuts[-1][1] == m
    for (a0, a1), (b0, _) in zip(cuts, cuts[1:]):
        assert a1 == b0  # no gap, no overlap, in split order
    assert all(lo < hi for lo, hi in cuts)


@pytest.mark.parametrize("m,rows,cols,sms", CASES)
def test_tiles_times_splits_fit_one_wave(m, rows, cols, sms):
    splits = split_plan(m, rows, cols, sms)
    tiles = _tiles(rows, cols)
    assert splits >= 1
    if tiles <= sms:
        assert tiles * splits <= sms
    else:
        assert splits == 1  # the tiles alone fill a wave


@pytest.mark.parametrize("m,rows,cols,sms", CASES)
def test_every_split_is_a_whole_box_deep(m, rows, cols, sms):
    """Splits start on a box boundary, and every split but one that ends
    at M is at least one box (one TMA load along M) deep."""
    cuts = split_rows(m, split_plan(m, rows, cols, sms))
    for lo, hi in cuts:
        assert lo % BOX_M == 0
        assert hi - lo >= BOX_M or hi == m


@pytest.mark.parametrize("rows,cols", TRAIN_OUT)
def test_train_shapes_fill_most_of_the_card(rows, cols):
    """At M = 2048 the plan keeps at least half of an H100's SMs busy
    unless the boxes of M are the limit."""
    splits = split_plan(M_TRAIN, rows, cols, H100_SMS)
    ctas = _tiles(rows, cols) * splits
    assert ctas * 2 >= H100_SMS or splits == -(-M_TRAIN // BOX_M)


def test_plan_at_the_train_shapes():
    """The plan's choice at each train output on the H100, as PERF.md's
    tables assume."""
    got = {out: split_plan(M_TRAIN, *out, H100_SMS) for out in TRAIN_OUT}
    assert got == {(80, 320): 16, (120, 320): 16, (239, 960): 4, (240, 960): 4,
                   (256, 960): 4, (256, 2560): 1, (349, 960): 2, (349, 2560): 1,
                   (960, 80): 8, (960, 120): 8, (960, 239): 4, (960, 240): 4,
                   (960, 256): 4, (960, 349): 2, (2560, 256): 1, (2560, 349): 1}


# (M, C) of dx at the train shapes (C is 960 or 2560 for every projection),
# then ragged, one row, many row blocks, and another card's SM count
DX_CASES = ([(M_TRAIN, c, H100_SMS) for c in (960, 2560)]
            + [(1, 960, H100_SMS), (8, 320, H100_SMS), (1000, 33, H100_SMS),
               (2500, 960, H100_SMS), (100_000, 2560, H100_SMS), (2048, 960, 78)])


@pytest.mark.parametrize("m,c,sms", DX_CASES)
def test_dx_tiles_cover_every_output_tile_once(m, c, sms):
    g, groups = dx_plan(m, c, sms)
    walked = [t for cta in dx_tiles(m, c, g, groups) for t in cta]
    assert len(walked) == len(set(walked))
    assert set(walked) == {(rb, tc) for rb in range(-(-m // DX_ROWS))
                           for tc in range(-(-c // DX_COLS))}


@pytest.mark.parametrize("m,c,sms", DX_CASES)
def test_dx_grid_is_at_most_one_wave_and_busy(m, c, sms):
    """At most one CTA an SM, every CTA with work, and no CTA with more
    than one tile above its fair share of the row block it walks."""
    g, groups = dx_plan(m, c, sms)
    tiles = dx_tiles(m, c, g, groups)
    assert 1 <= g * groups <= sms
    assert all(tiles)
    per_block = -(-c // DX_COLS)
    assert max(len(t) for t in tiles) <= -(-(-(-m // DX_ROWS)) // groups) * -(-per_block // g)


def test_dx_plan_at_the_train_shapes():
    """The plan's choice at each train dx on the H100, as PERF.md's tables
    assume: 128 CTAs, 16 row blocks of 128 shared by 8 CTAs each (one
    column tile each at C 960, two or three at C 2560)."""
    assert DX_ROWS == 128
    assert dx_plan(M_TRAIN, 960, H100_SMS) == (8, 16)
    assert dx_plan(M_TRAIN, 2560, H100_SMS) == (8, 16)
    assert sorted({len(t) for t in dx_tiles(M_TRAIN, 960, 8, 16)}) == [1]
    assert sorted({len(t) for t in dx_tiles(M_TRAIN, 2560, 8, 16)}) == [2, 3]


@pytest.mark.parametrize("r", [1, 120, 349, 512, 513, 640, 682, 822, 1024, 1365, 2048, 2049,
                               2133, 2580, 2609, 3185, 3207, 4095, 4096])
def test_dx_phase_two_fits_past_rank_512(r):
    """K2's phase 2 keeps a 128-row block of dt in shared memory up to r =
    512 (as before the ceiling rose), and streams it through the ring with
    U past that; either way it fits 227 KB with at least two ring slots."""
    from repro_torch.kernels.lowrank_bwd import dx_smem
    from repro_torch.kernels.lowrank_matmul import SMEM_MAX

    total, slots, stream = dx_smem(r)
    assert total <= SMEM_MAX and slots >= 2
    assert stream == (r > 512)


# (rows, cols) of dU and dV at Zamba2-1.2B's Eq.-5 train shapes: K3 and K4
# gain output tiles along r (up to 11 of 128 columns at r = 1365)
ZAMBA_OUT = sorted({out for c, r, s in [(2048, 822, 8384), (4096, 682, 2048),
                                        (4096, 1024, 4096), (4096, 1365, 8192),
                                        (8192, 1365, 4096)]
                    for out in ((c, r), (r, s))})


@pytest.mark.parametrize("rows,cols", ZAMBA_OUT)
def test_zamba_outputs_fill_a_wave_without_splits(rows, cols):
    """Every Zamba2 dU and dV has more 64 x 128 tiles than an H100 has SMs,
    so the sum over M is not split and nothing is reduced."""
    assert _tiles(rows, cols) > H100_SMS
    assert split_plan(M_TRAIN, rows, cols, H100_SMS) == 1


# (rows, cols) of dU and dV at rank 2048 and past it: the VLM's
# (llama-3.2-vision-90b, d 8192, SwiGLU 28672) FFN at its Eq.-5 rank 3185
# and its attention's wq/wo (2048), and the large dense configs' FFNs
# (qwen3-32b 5120 x 25600 r 2133, deepseek-coder-33b 7168 x 19200 r 2609,
# qwen2-72b 8192 x 29568 r 3207, DeepSeek-V3's dense 7168 x 18432 r 2580)
WIDE_OUT = sorted({out for c, r, s in [(8192, 3185, 28672), (28672, 3185, 8192),
                                       (8192, 2048, 8192),
                                       (5120, 2133, 25600), (25600, 2133, 5120),
                                       (7168, 2609, 19200), (19200, 2609, 7168),
                                       (8192, 3207, 29568), (29568, 3207, 8192),
                                       (7168, 2580, 18432), (18432, 2580, 7168)]
                   for out in ((c, r), (r, s))})


@pytest.mark.parametrize("rows,cols", WIDE_OUT)
def test_wide_rank_outputs_fill_a_wave_without_splits(rows, cols):
    """Every dU and dV of those geometries has more 64 x 128 tiles than an
    H100 has SMs, so at the train M the sum over M is not split; K2's
    plan keeps one wave over the dx of the same geometry."""
    assert _tiles(rows, cols) > H100_SMS
    assert split_plan(M_TRAIN, rows, cols, H100_SMS) == 1
    g, groups = dx_plan(M_TRAIN, rows, H100_SMS)
    assert 1 <= g * groups <= H100_SMS
