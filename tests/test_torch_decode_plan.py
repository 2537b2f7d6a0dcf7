"""The decode design's launch plan (``kernels/lowrank_matmul.py``:
``decode_plan``, which K1's and K5's wrappers pass to the kernels), checked
on the CPU against a mirror of ``launch_decode`` and the two phases' index
math (``csrc/common.cuh``): the C split, the tiles of r and of S and the row
blocks cover every element of U and V exactly once for each row block; the
split of C, which fixes the order in which a row's products are summed, is
the same at every M; both phases fit in shared memory up to ``LARGE_M - 1``
rows; and at the decode M (8 to 40) each phase is at most one wave (two
past rank 512).  Then a float32 emulation of that order (each rank's slab
in four chains of 16-deep steps, the cluster's partials added in rank
order, t formed once, phase 2's chains over the padded rank, piece by
piece past rank 512) against JAX's Pallas kernels in interpret mode."""

import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.lowrank_ffn import lowrank_gated_ffn as pallas_gated_ffn
from repro.kernels.lowrank_matmul import lowrank_matmul as pallas_lowrank_matmul
from repro_torch.kernels import lowrank_ffn as k5
from repro_torch.kernels import lowrank_matmul as k1

torch.set_num_threads(1)

SMS = 132  # an H100 SXM's SMs
SMEM_MAX = 232448  # bytes of shared memory a CTA may use
ROWS_MAX, BM = 128, 16  # csrc kDRows, kBM
TOL = 1e-5  # float32: the same products, summed in the plan's order against the TPU kernel's

# (C, r, S) of K1 on the main paths at decode M (serve, verify, the derived
# draft, OLMoE's attention) and the train paths' other geometries
K1_SHAPES = [(960, 240, 960), (960, 120, 320), (2560, 349, 960), (960, 119, 960),
             (960, 59, 320), (2560, 128, 960), (2048, 512, 2048), (960, 349, 2560),
             (960, 239, 960), (960, 80, 320), (960, 256, 2560), (2560, 256, 960)]
# (C, (rg, ru), F) of K5: the Eq.-5 and draft ranks, Algorithm 1's, the largest
K5_SHAPES = [(960, (349, 349), 2560), (960, (128, 128), 2560), (960, (256, 256), 2560),
             (960, (512, 512), 2560)]
DECODE_MS = [8, 16, 24, 40]
# K1 past rank 512: Zamba2-1.2B's factorised projections at Eq.-5 and
# Algorithm-1 ranks (mamba in_proj, out_proj and the shared down_proj;
# the shared block's attention; its GELU FFN's wi and down), the first rank
# past the old ceiling, and the new ceiling
WIDE_K1 = [(2048, 822, 8384), (4096, 682, 2048), (4096, 1024, 4096), (4096, 1365, 8192),
           (8192, 1365, 4096), (2048, 640, 8384), (4096, 640, 2048), (4096, 896, 4096),
           (4096, 1280, 8192), (8192, 1280, 4096), (960, 513, 960), (4096, 2048, 4096)]
# past rank 2048 (K1) and 512 (K5): the VLM's (llama-3.2-vision-90b, d 8192,
# SwiGLU 28672, Eq.-5 ranks 2048 / 455 / 3185) and the large dense configs'
# FFNs at their Eq.-5 ranks (qwen3-32b 2133, deepseek-coder-33b 2609,
# qwen2-72b 3207, DeepSeek-V3's dense layers 2580): K1 on the gate/up branch
# (the backward's recompute) and down, K5 on both branches; the first rank
# past each old ceiling, the new ceiling, and K5 with unequal branch ranks
FFN_WIDE = [(8192, 3185, 28672), (5120, 2133, 25600), (7168, 2609, 19200), (8192, 3207, 29568),
            (7168, 2580, 18432)]
HUGE_K1 = ([(8192, 2048, 8192), (8192, 455, 1024)] + FFN_WIDE + [(f, r, c) for c, r, f in FFN_WIDE]
           + [(960, 2049, 960), (4096, 4096, 4096)])
HUGE_K5 = ([(c, (r, r), f) for c, r, f in FFN_WIDE]
           + [(960, (513, 513), 960), (960, (513, 700), 2560), (4096, (4096, 4096), 4096)])


def _cdiv(a, b):
    return -(-a // b)


def _round_up(a, b):
    return _cdiv(a, b) * b


def _random_shapes(n, seed):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        c, s = (int(v) for v in rng.integers(1, 2561, 2))
        ranks = tuple(int(v) for v in rng.integers(1, 513, int(rng.integers(1, 3))))
        out.append((c, ranks, s))
    return out


RANDOM = _random_shapes(24, 0)
ALL = [(c, (r,), s) for c, r, s in K1_SHAPES] + K5_SHAPES + RANDOM
WIDE = [(c, (r,), s) for c, r, s in WIDE_K1]
HUGE = [(c, (r,), s) for c, r, s in HUGE_K1] + HUGE_K5


def _large_m(c, ranks):
    return k1.large_m(c, ranks[0]) if len(ranks) == 1 else k5.LARGE_M


# --------------------------------------------------------------------------
# A mirror of csrc launch_decode
# --------------------------------------------------------------------------

def tile_ld(w):
    return w + 16 if (w // 8) % 2 else w + 8


def _align128(n):
    return (n + 127) & ~127


def rank_smem(rows, kc, w1, cs):
    """Phase 1: x [rows][tile_ld(kc)] bf16 | U [kc][tile_ld(w1)] bf16 | the
    CTA's sums [rows][w1] float32 | the sums pushed to it [cs][own] float32."""
    u = _align128(2 * rows * tile_ld(kc))
    part = u + _align128(2 * kc * tile_ld(w1))
    recv = part + _align128(4 * rows * w1)
    return recv + 4 * cs * _cdiv(rows * w1, cs)


def block_rows(m, smem):
    rows = _round_up(m, BM) if m < ROWS_MAX else ROWS_MAX
    while rows > BM and smem(rows) > SMEM_MAX:
        rows -= BM
    return rows


def launch(m, c, ranks, s, sms=SMS):
    """What launch_decode launches for M rows: the plan, the tile widths
    widened by the row blocks' count, rows a CTA, both grids and their
    shared memory."""
    nb, rmax = len(ranks), max(ranks)
    cs, kc, per, w1, w2 = k1.decode_plan(c, rmax, s, sms, nb=nb)
    kext = _round_up(rmax, BM)
    blocks = _cdiv(m, block_rows(m, lambda rows: rank_smem(rows, kc, w1, cs)))
    w1, w2 = min(k1.W1_MAX, w1 * blocks), min(k1.W2_MAX, w2 * blocks)

    def tiles(w):
        return sum(_cdiv(r, w) for r in ranks)

    rows1 = block_rows(m, lambda rows: rank_smem(rows, kc, w1, cs))
    # phase 2's layout, one piece of decode_kp rank rows (the library's mirror)
    rows2 = block_rows(m, lambda rows: k1.decode_out_smem(rows, rmax, w2, nb))
    return dict(cs=cs, kc=kc, per=per, w1=w1, w2=w2, kext=kext, kp=k1.decode_kp(rmax),
                rows1=rows1, rows2=rows2,
                grid1=(cs, tiles(w1), _cdiv(m, rows1)), grid2=(_cdiv(s, w2), _cdiv(m, rows2)),
                smem1=rank_smem(rows1, kc, w1, cs), smem2=k1.decode_out_smem(rows2, rmax, w2, nb))


def _check_plan_limits(p, c):
    assert 1 <= p["cs"] <= k1.CLUSTER_MAX and p["per"] >= 1
    assert p["kc"] % 16 == 0 and 16 <= p["kc"] <= k1.KC_MAX
    assert _cdiv(c, p["kc"] * p["per"]) == p["cs"]  # every CTA of a cluster has rows of C
    assert p["w1"] % 8 == 0 and 8 <= p["w1"] <= k1.W1_MAX
    assert p["w2"] % 8 == 0 and 8 <= p["w2"] <= k1.W2_MAX


# --------------------------------------------------------------------------
# The plan
# --------------------------------------------------------------------------

@pytest.mark.parametrize("m", [1, 8, 40, 127, 300])
@pytest.mark.parametrize("c,ranks,s", ALL + [(64, (600,), 64), (100, (2048,), 90),
                                             (100, (4096,), 90), (96, (1500, 3000), 70)])
def test_decode_plan_covers_u_and_v_once_per_row_block(m, c, ranks, s):
    """Mirror of the CTA -> work maps (decode_rank_body: CTA (q, tile,
    block) sums rows [(q per + pc) kc, +kc) of C for pc < per, columns
    [n0, n0 + w1) of its branch's t, rows [rows1 block, ...) of x;
    decode_out_body: CTA (tile, block) every rank row of V's columns [w2
    tile, ...)): each element of every U and V is read once a row block,
    every row of M is in one block, and each element of t and y is formed
    once."""
    p = launch(m, c, ranks, s)
    _check_plan_limits(p, c)
    cs, kc, per, w1, w2 = p["cs"], p["kc"], p["per"], p["w1"], p["w2"]
    assert p["grid1"][0] == cs
    u_hits = [np.zeros((c, r), np.int64) for r in ranks]
    tiles0 = _cdiv(ranks[0], w1)
    for y in range(p["grid1"][1]):
        b = 0 if y < tiles0 else 1
        n0 = (y - (tiles0 if b else 0)) * w1
        for q in range(cs):
            for pc in range(per):
                c0 = (q * per + pc) * kc
                u_hits[b][c0:min(c0 + kc, c), n0:min(n0 + w1, ranks[b])] += 1
    assert all((h == 1).all() for h in u_hits)
    v_hits = [np.zeros((r, s), np.int64) for r in ranks]
    for x in range(p["grid2"][0]):
        for h in v_hits:
            h[:, x * w2:min(x * w2 + w2, s)] += 1
    assert all((h == 1).all() for h in v_hits)
    for rows, blocks in ((p["rows1"], p["grid1"][2]), (p["rows2"], p["grid2"][1])):
        cover = np.zeros(m, np.int64)
        for z in range(blocks):
            cover[z * rows:min(z * rows + rows, m)] += 1
        assert (cover == 1).all() and rows % BM == 0


def test_decode_plan_takes_no_m():
    assert list(inspect.signature(k1.decode_plan).parameters) == ["c", "r", "s", "sms", "nb"]


@pytest.mark.parametrize("c,ranks,s", ALL + WIDE + HUGE)
def test_decode_sum_order_is_the_same_at_every_m(c, ranks, s):
    """The split of C (cs, kc, per), the padded rank of phase 2 (kext) and
    its pieces (kp) fix the order of a row's sums; widths and row blocks
    only share the work out.  They are the same at every M, so a row has
    the same bits at M = 8 and inside M = 16, 24, 40 or LARGE_M - 1."""
    orders = {tuple(launch(m, c, ranks, s)[key] for key in ("cs", "kc", "per", "kext", "kp"))
              for m in [1] + DECODE_MS + [_large_m(c, ranks) - 1, 1000]}
    assert len(orders) == 1


@pytest.mark.parametrize("c,ranks,s", ALL + WIDE + HUGE)
def test_decode_fits_shared_memory_below_large_m(c, ranks, s):
    for m in sorted({1, 8, 16, 40, 64, 127, 128, 129, _large_m(c, ranks) - 1}):
        p = launch(m, c, ranks, s)
        assert p["smem1"] <= SMEM_MAX and p["smem2"] <= SMEM_MAX, (m, p)


@pytest.mark.parametrize("r", [1, 16, 240, 512, 513, 528, 640, 682, 822, 1024, 1365, 2048,
                               2049, 2133, 2580, 2609, 3185, 3207, 4095, 4096])
def test_decode_rank_pieces(r):
    """Phase 2 holds the whole padded rank up to 512 rows (one piece, as
    before the ceiling rose), else the fewest equal pieces of at most 512
    rows (multiples of 16) that cover it; the t scratch's row pitch is r
    rounded up to 8."""
    kext, kp = _round_up(r, BM), k1.decode_kp(r)
    assert kp % BM == 0 and kp <= k1.KP_MAX
    pieces = _cdiv(kext, kp)
    assert (kp == kext) == (kext <= k1.KP_MAX)
    assert pieces == _cdiv(kext, k1.KP_MAX) and (pieces - 1) * kp < kext <= pieces * kp
    assert k1.decode_rt(r) == _round_up(r, 8) and k1.decode_rt(r) >= r


@pytest.mark.parametrize("m", DECODE_MS)
@pytest.mark.parametrize("c,ranks,s", WIDE)
def test_decode_is_at_most_two_waves_past_rank_512(m, c, ranks, s):
    """Zamba2's ranks take 11 to 32 tiles of 64 columns of t against
    clusters of up to 8 CTAs: phase 1 is at most two waves, phase 2 at most
    two CTAs an SM (one row block)."""
    p = launch(m, c, ranks, s)
    assert p["grid1"][2] == p["grid2"][1] == 1
    assert np.prod(p["grid1"]) <= 2 * SMS
    assert np.prod(p["grid2"]) <= 2 * SMS


@pytest.mark.parametrize("m", [8, 16, 24, 32])
@pytest.mark.parametrize("c,ranks,s", HUGE)
def test_decode_keeps_one_row_block_past_rank_2048(m, c, ranks, s):
    """Past K1's old ceiling and K5's, up to 32 rows (the VLM serves 8),
    both phases hold every row in one block, so V is read once a call (K5's
    phase 2, two branches of 464-row pieces at r 3185, holds 32 rows), and
    phase 2 walks at most 8 pieces of at most 512 rank rows (8 at 4096)."""
    p = launch(m, c, ranks, s)
    assert p["grid1"][2] == p["grid2"][1] == 1
    assert p["kp"] <= k1.KP_MAX
    assert _cdiv(p["kext"], p["kp"]) == _cdiv(p["kext"], k1.KP_MAX) <= 8


@pytest.mark.parametrize("m", DECODE_MS)
@pytest.mark.parametrize("c,ranks,s", ALL)
def test_decode_is_at_most_one_wave_at_decode_m(m, c, ranks, s):
    """Phase 1 at most one CTA an SM (the rank kernel holds one a SM by its
    registers), phase 2 at most two (the out kernel's registers allow two);
    one row block."""
    p = launch(m, c, ranks, s)
    assert p["grid1"][2] == p["grid2"][1] == 1
    assert np.prod(p["grid1"]) <= SMS
    if s <= 2 * SMS * k1.W2_MAX:
        assert np.prod(p["grid2"]) <= 2 * SMS


@pytest.mark.parametrize("c,r,s", [(960, 240, 960), (2560, 349, 960), (2048, 512, 2048)])
def test_decode_spreads_the_rank_product_at_decode(c, r, s):
    """The serve path's widest factors: U is spread over a few dozen CTAs
    at least (the design before split it over 8 to 40 CTAs, each walking
    its share of C chunk by chunk), each with one slab."""
    p = launch(8, c, (r,), s)
    assert np.prod(p["grid1"]) >= 48 and p["per"] == 1


# --------------------------------------------------------------------------
# The plan's order of sums, emulated in float32, against the TPU kernels
# --------------------------------------------------------------------------

def _chains(a, b):
    """a (M, K) @ b (K, N) as tile_product sums it: 16-deep steps, step k in
    chain k % 4, each chain summed in step order, added as (c0 + c1) +
    (c2 + c3); K is zero-padded to whole steps."""
    k = a.shape[1]
    kp = _round_up(max(k, 1), 16)
    a = np.pad(a, ((0, 0), (0, kp - k)))
    b = np.pad(b, ((0, kp - k), (0, 0)))
    chains = [np.zeros((a.shape[0], b.shape[1]), np.float32) for _ in range(4)]
    for step in range(kp // 16):
        sl = slice(16 * step, 16 * step + 16)
        chains[step % 4] = chains[step % 4] + (a[:, sl] @ b[sl, :]).astype(np.float32)
    return (chains[0] + chains[1]) + (chains[2] + chains[3])


def _rank_product(x, u, plan):
    """Phase 1: each cluster rank's slab, piece by piece, then the ranks'
    partials added in rank order and t formed once (x's dtype: float32)."""
    cs, kc, per = plan[:3]
    c = x.shape[1]
    total = np.zeros((x.shape[0], u.shape[1]), np.float32)
    for q in range(cs):
        part = None
        for pc in range(per):
            c0 = (q * per + pc) * kc
            d = _chains(x[:, c0:min(c0 + kc, c)], u[c0:min(c0 + kc, c)])
            part = d if part is None else part + d
        total = total + part
    return total.astype(x.dtype)


def emulate_k1(x, u, v, plan):
    """Phase 2 over the padded rank in decode_kp pieces, each piece's chains
    added to the sum of those before it."""
    t = _rank_product(x, u, plan)
    r = u.shape[1]
    kp = k1.decode_kp(r)
    out = None
    for k0 in range(0, r, kp):
        d = _chains(t[:, k0:k0 + kp], v[k0:k0 + kp])
        out = d if out is None else out + d
    return out


def _pieces(t, v, kp):
    """Phase 2 of one branch over its rank in pieces of ``kp`` rows, each
    piece's chains added to the sum of those before it."""
    out = None
    for k0 in range(0, t.shape[1], kp):
        d = _chains(t[:, k0:k0 + kp], v[k0:k0 + kp])
        out = d if out is None else out + d
    return out


def emulate_k5(x, gu, gv, uu, uv, plan):
    """Both branches piece by piece (the larger rank's decode_kp), then
    silu(g) * u on the whole float32 sums."""
    kp = k1.decode_kp(max(gu.shape[1], uu.shape[1]))
    g = _pieces(_rank_product(x, gu, plan), gv, kp)
    up = _pieces(_rank_product(x, uu, plan), uv, kp)
    return (g / (1.0 + np.exp(-g)) * up).astype(np.float32)


def _mats(seed, *shapes):
    rng = np.random.default_rng(seed)
    out = [rng.standard_normal(shapes[0]).astype(np.float32)]
    for shape in shapes[1:]:
        out.append((rng.standard_normal(shape) / np.sqrt(shape[0])).astype(np.float32))
    return out


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got, np.float32), np.asarray(want, np.float32),
                               rtol=TOL, atol=TOL)


# (m, c, r, s, bm, bk, bn): block-divisible for the Pallas kernels; plans: the
# wrapper's and one with two pieces of C a CTA
EMU_K1 = [(64, 128, 32, 64, 32, 64, 32), (32, 256, 48, 128, 32, 128, 64),
          (40, 256, 24, 96, 8, 128, 32)]
# past rank 512: phase 2 in two and three pieces
EMU_WIDE = [(16, 64, 520, 64, 16, 64, 32), (8, 128, 1100, 32, 8, 64, 32)]


@pytest.mark.parametrize("m,c,r,s,bm,bk,bn", EMU_K1 + EMU_WIDE)
def test_decode_order_matches_pallas_lowrank_matmul(m, c, r, s, bm, bk, bn):
    x, u, v = _mats(m + c + r + s, (m, c), (c, r), (r, s))
    want = pallas_lowrank_matmul(jnp.asarray(x), jnp.asarray(u), jnp.asarray(v), block_m=bm,
                                 block_k=bk, block_n=bn, interpret=True)
    for plan in (k1.decode_plan(c, r, s, SMS), (_cdiv(c, 64), 32, 2, 8, 16)):
        _close(emulate_k1(x, u, v, plan), want)
    # a row's result does not depend on the other rows
    _close(emulate_k1(x[:8], u, v, k1.decode_plan(c, r, s, SMS)),
           emulate_k1(x, u, v, k1.decode_plan(c, r, s, SMS))[:8])


@pytest.mark.parametrize("m,c,r,f,bm,bk,bn", [(32, 128, 16, 64, 32, 64, 32),
                                              (64, 64, 24, 128, 32, 64, 64),
                                              (16, 64, 520, 64, 16, 64, 32),
                                              (8, 128, 1100, 32, 8, 64, 32)])
def test_decode_order_matches_pallas_lowrank_gated_ffn(m, c, r, f, bm, bk, bn):
    x, gu, gv, uu, uv = _mats(m + c + r + f, (m, c), (c, r), (r, f), (c, r), (r, f))
    want = pallas_gated_ffn(*(jnp.asarray(a) for a in (x, gu, gv, uu, uv)), block_m=bm,
                            block_k=bk, block_n=bn, interpret=True)
    for plan in (k1.decode_plan(c, r, f, SMS, nb=2), (_cdiv(c, 32), 32, 1, 16, 16)):
        _close(emulate_k5(x, gu, gv, uu, uv, plan), want)


# --------------------------------------------------------------------------
# The large-M design and the rank ceilings, nothing launched
# --------------------------------------------------------------------------

@pytest.mark.parametrize("r", [1, 120, 256, 349, 512, 513, 640, 682, 822, 1024, 1365, 2048,
                               2049, 2133, 2580, 2609, 3185, 3207, 4096])
def test_large_m_layout_fits_past_rank_512(r):
    """The large-M layout keeps the row block's t in shared memory up to a
    padded rank of 512 and streams it with V past that, for K1 (stages of
    128 ranks) and K5 (two branches, 64 ranks each a stage); either way it
    fits 227 KB with at least two ring slots."""
    total, slots, stream = k1.large_smem(r)
    assert total <= SMEM_MAX and slots >= 2
    assert stream == (_round_up(r, 128) > 512)
    total, slots, stream = k1.large_smem(r, nb=2)
    assert total <= SMEM_MAX and slots >= 2
    assert stream == (_round_up(r, 64) > 512)


def _meta(*shapes):
    return [torch.empty(s, dtype=torch.bfloat16, device="meta") for s in shapes]


def test_wrappers_refuse_ranks_past_their_ceilings():
    """K1-K5 and K7 take r up to RANK_MAX (4096): the wrappers refuse a
    larger rank before touching a device, naming the ROADMAP item that
    would raise it."""
    from repro_torch.kernels import int8_matmul as k7
    from repro_torch.kernels import lowrank_bwd as kb

    assert (k1.RANK_MAX, k5.FFN_RANK_MAX) == (4096, 4096)
    r = k1.RANK_MAX + 1
    x, u, v, dy = _meta((8, 64), (64, r), (r, 32), (8, 32))
    with pytest.raises(ValueError, match=f"rank {r} .*item 13"):
        k1.lowrank_matmul(x, u, v)
    for fn, args in ((kb.lowrank_matmul_dx, (dy, u, v)), (kb.lowrank_matmul_du, (x, dy, v)),
                     (kb.lowrank_matmul_dv, (x, u, dy))):
        with pytest.raises(ValueError, match=f"rank {r} .*item 13"):
            fn(*args)
    with pytest.raises(ValueError, match=f"{r}.*item 13"):
        k5.lowrank_gated_ffn(x, u, v, u, v)
    uq = torch.empty((64, r), dtype=torch.int8, device="meta")
    vq = torch.empty((r, 32), dtype=torch.int8, device="meta")
    scales = [torch.empty(s, dtype=torch.float32, device="meta") for s in ((1, r), (1, 32))]
    with pytest.raises(ValueError, match=f"rank {r} .*item 13"):
        k7.int8_lowrank_linear(x, uq, scales[0], vq, scales[1])
    with pytest.raises(ValueError, match=f"rank {r} .*item 13"):
        k7.int8_lowrank_matmul(torch.empty((8, 64), dtype=torch.int8, device="meta"), uq,
                               scales[0], vq, scales[1])
