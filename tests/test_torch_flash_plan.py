"""K8's work order (``repro_torch.kernels.flash_attention.flash_units``,
``flash_grid`` and ``flash_plan``): how the (q head, 128-row q tile) units
of a flash-attention call are ordered and handed to the CTAs of a
persistent grid.  Plain Python, so it runs without a card: the kernel
walks the units exactly as these functions list them, on the grid that
``flash_grid`` gives the wrapper."""

import pytest
import torch

from repro_torch.kernels.flash_attention import (KV_TILE, ROWS, UNIT_ROWS, flash_grid,
                                                 flash_plan, flash_unit_count, flash_units)

torch.set_num_threads(1)

H100_SMS = 132
# (B, Sq, Sk, H, KV, D, causal): the serve shape (smollm-360m, a 2016-token
# prompt), the flash checks' ragged / non-causal / batched / D 128 shapes,
# and the gpu tests' GQA shapes
SHAPES = [(1, 2016, 2016, 15, 5, 64, True), (1, 1, 1, 15, 5, 64, True),
          (1, 17, 17, 15, 5, 64, True), (1, 2016, 500, 15, 5, 64, False),
          (2, 2016, 2016, 15, 5, 64, True), (1, 512, 512, 64, 8, 128, True),
          (2, 200, 200, 15, 5, 64, True), (1, 50, 300, 6, 2, 64, True),
          (2, 1000, 1000, 9, 3, 64, True), (3, 70, 90, 4, 1, 64, False),
          (2, 77, 200, 8, 1, 64, True), (3, 33, 95, 3, 3, 128, True)]


def _visible_tiles(sq, sk, first_row, causal):
    """kv tiles a 64-row q tile starting at ``first_row`` needs."""
    nk = -(-sk // KV_TILE)
    if not causal:
        return nk
    return min(nk, (min(first_row + ROWS, sq) - 1) // KV_TILE + 1)


@pytest.mark.parametrize("b,sq,sk,h,kv,d,causal", SHAPES)
def test_units_cover_every_head_and_q_tile_once(b, sq, sk, h, kv, d, causal):
    units = flash_units(b, sq, sk, h, kv, causal)
    assert len(units) == flash_unit_count(b, sq, h)
    covered = [(bb, head, q0) for bb, head, q0s, _, _ in units for q0 in q0s if q0 < sq]
    assert len(covered) == len(set(covered))
    assert set(covered) == {(bb, head, q0) for bb in range(b) for head in range(h)
                            for q0 in range(0, sq, ROWS)}


@pytest.mark.parametrize("b,sq,sk,h,kv,d,causal", SHAPES)
def test_units_read_their_kv_head_and_load_every_tile_they_need(b, sq, sk, h, kv, d, causal):
    """A unit is UNIT_ROWS rows of one head, reads that head's kv head, and
    loads every kv tile its rows see, and none past the last of them."""
    for _, head, q0s, hk, nk in flash_units(b, sq, sk, h, kv, causal):
        assert q0s == list(range(q0s[0], q0s[0] + UNIT_ROWS, ROWS))
        assert q0s[0] % UNIT_ROWS == 0 and q0s[0] < sq
        assert hk == head // (h // kv)
        assert nk == max(_visible_tiles(sq, sk, q0, causal) for q0 in q0s if q0 < sq)


@pytest.mark.parametrize("b,sq,sk,h,kv,d,causal", SHAPES)
def test_units_go_heaviest_first(b, sq, sk, h, kv, d, causal):
    loads = [nk for *_, nk in flash_units(b, sq, sk, h, kv, causal)]
    assert loads == sorted(loads, reverse=True)


@pytest.mark.parametrize("b,sq,sk,h,kv,d,causal", SHAPES)
def test_plan_hands_every_unit_to_one_cta_of_one_wave(b, sq, sk, h, kv, d, causal):
    n = flash_unit_count(b, sq, h)
    plan = flash_plan(n, H100_SMS)
    assert len(plan) == flash_grid(n, H100_SMS) <= H100_SMS  # one wave, the wrapper's grid
    assert all(plan)  # every CTA has work
    taken = [p for cta in plan for p in cta]
    assert sorted(taken) == list(range(n))
    assert all(cta == sorted(cta) for cta in plan)  # each CTA walks heaviest first too


@pytest.mark.parametrize("sms", [H100_SMS, 114, 78])
def test_plan_at_the_serve_shape_is_one_balanced_wave(sms):
    """At the serve shape (and on cards with fewer SMs) the snake keeps
    every CTA's kv tiles within one unit's worth of the heaviest CTA's."""
    units = flash_units(1, 2016, 2016, 15, 5, True)
    plan = flash_plan(len(units), sms)
    assert len(plan) == min(len(units), sms)
    loads = [sum(units[p][4] for p in cta) for cta in plan]
    assert max(loads) - min(loads) <= max(u[4] for u in units)


def test_unit_count_at_the_model_shapes():
    """smollm-360m's 15 heads of a 2016-token prompt are 240 units of
    128 rows, more than one wave, so the grid is the card's 132 SMs; a
    short prompt takes one CTA a unit."""
    assert UNIT_ROWS == 128
    assert flash_unit_count(1, 2016, 15) == 15 * 16
    assert flash_grid(flash_unit_count(1, 2016, 15), H100_SMS) == H100_SMS
    assert flash_unit_count(1, 17, 15) == 15
    assert flash_grid(15, H100_SMS) == 15
    assert flash_unit_count(2, 129, 8) == 2 * 8 * 2
