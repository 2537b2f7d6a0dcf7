"""The K3/K4 split plan (``repro_torch.kernels.lowrank_bwd.split_plan`` and
``split_rows``): how the sum over M of dU and dV is cut among CTAs.  Plain
Python, so it runs without a card: the kernel cuts M exactly as
``split_rows`` says, and ``split_plan`` picks the number of cuts from the
output's shape and the card's SM count."""

import pytest
import torch

from repro_torch.kernels.lowrank_bwd import (BOX_M, TILE_COLS, TILE_ROWS, split_plan,
                                             split_rows)

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
