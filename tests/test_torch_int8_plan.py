"""K6's and K7's launch plans (``kernels/int8_matmul.py``: ``k6_plan``,
``k7_plan``, which the wrappers pass to the kernels), checked on the CPU
against a mirror of the CUDA kernels' grids and index math (``csrc/int8_matmul.cu``,
``gemm_body`` and ``k7_out_kernel``): every output element and every
128-row chunk of C is covered exactly once, every CTA of a cluster has a
chunk, a CTA's slab of x fits in shared memory, and K7 at M = 8 fills the
card in both phases.  Also the kernels' fragment layout, emulated in numpy:
x stored in the MMA's permuted k order and B's registers built by a 4 x 4
byte transpose give the plain product."""

import numpy as np
import pytest
import torch

from repro_torch.kernels import int8_matmul as k

torch.set_num_threads(1)

SMS = 132  # an H100 SXM's SMs
SMEM_MAX = 232448  # bytes of shared memory a CTA may use
# (C, S) of the int8 export at full width, then ragged edges
K6_SHAPES = [(960, 960), (960, 320), (960, 2560), (2560, 960), (70, 33), (100, 1000)]
# (C, r, S): the analytic export's, the Eq.-5 rank, the largest rank, ragged
K7_SHAPES = [(960, 128, 960), (960, 119, 320), (960, 256, 2560), (2560, 256, 960),
             (2560, 349, 960), (960, 512, 960), (70, 1, 33), (100, 119, 1000)]
SERVED_K7 = K7_SHAPES[:4]
MS = [1, 8, 128, 2048]


def _cdiv(a, b):
    return -(-a // b)


def k6_grid(m, c, s):
    """K6's grid as the wrapper launches it (csrc launch_gemm): x the
    cluster rank, y the column tile, z the row block."""
    cs, _ = k.k6_plan(m, c, s, SMS)
    return cs, _cdiv(s, k.TILE), _cdiv(m, k.ROWS)


def k7_grids(m, c, r, s):
    """K7's two grids (csrc launch_gemm, launch_out): phase 1 as K6's on
    tiles of w1 columns of r; phase 2 (x the column tile of S, y the row
    block)."""
    (w1, cs, _), w2 = k.k7_plan(m, c, r, s, SMS)
    blocks = _cdiv(m, k.ROWS)
    return (cs, _cdiv(r, w1), blocks), (_cdiv(s, w2), blocks)


def gemm_smem(per):
    """Dynamic shared memory of gemm_body (csrc gemm_smem): the B ring, the
    x slab, the four warps' partial sums and a slot of sums for each rank
    of the cluster, the row maxima, scales and reciprocals, the tile's
    w_scale, the ring's mbarriers."""
    return (4 * k.CHUNK * k.TILE + k.ROWS * (per * k.CHUNK + 16)
            + 4 * (4 + k.CLUSTER_MAX) * k.ROWS * k.TILE + 4 * (3 * k.ROWS + k.TILE) + 4 * 8)


def gemm_cover(m, c, n, w, cs, per):
    """Mirror of gemm_body's CTA -> work map over the grid (cs, cdiv(n, w),
    cdiv(m, 16)): how often each (row, column, chunk) is summed, and the
    chunks of every CTA."""
    chunks = _cdiv(c, k.CHUNK)
    hits = np.zeros((m, n, chunks), dtype=np.int64)
    per_cta = []
    for q in range(cs):
        first = q * per
        nch = min(per, chunks - first)
        per_cta.append(nch)
        for tile in range(_cdiv(n, w)):
            n0 = tile * w
            cols = slice(n0, min(n0 + w, n))
            for blk in range(_cdiv(m, k.ROWS)):
                rows = slice(blk * k.ROWS, min(blk * k.ROWS + k.ROWS, m))
                hits[rows, cols, first:first + nch] += 1
    return hits, per_cta


def _check_width(w):
    """32, or at most 16: a TMA box of 32 columns from the 16-byte boundary
    at or before the tile then holds it (csrc tma_ok)."""
    assert w == k.TILE or 1 <= w <= 16


def _check_gemm(m, c, n, w, cs, per):
    _check_width(w)
    assert 1 <= cs <= k.CLUSTER_MAX and 1 <= per <= k.PER_MAX
    hits, per_cta = gemm_cover(m, c, n, w, cs, per)
    assert (hits == 1).all()  # every output element sums every chunk once
    assert min(per_cta) >= 1  # no CTA of a cluster without a chunk
    assert gemm_smem(per) <= SMEM_MAX
    # the cluster's reduction: output e = 32 row + column of a tile belongs
    # to rank (e cs) >> 9, which partitions a tile's 16 x 32 outputs
    owners = [(e * cs) >> 9 for e in range(k.ROWS * k.TILE)]
    assert owners == sorted(owners) and set(owners) <= set(range(cs))


@pytest.mark.parametrize("m", MS)
@pytest.mark.parametrize("c,s", K6_SHAPES)
def test_k6_plan_covers_every_output_and_chunk_once(m, c, s):
    cs, per = k.k6_plan(m, c, s, SMS)
    _check_gemm(min(m, 128), c, s, k.TILE, cs, per)  # the row blocks repeat past 128
    grid = k6_grid(m, c, s)
    if m == 8 and c >= 960:  # decode: C split until the card holds about 2 CTAs an SM
        assert np.prod(grid) >= SMS / 2 and cs * per * k.CHUNK >= c


@pytest.mark.parametrize("m", MS)
@pytest.mark.parametrize("c,r,s", K7_SHAPES)
def test_k7_plan_covers_every_output_and_chunk_once(m, c, r, s):
    (w1, cs, per), w2 = k.k7_plan(m, c, r, s, SMS)
    # phase 1: t (M, r) as K6's product, on tiles of w1 columns of r
    _check_gemm(min(m, 128), c, r, w1, cs, per)
    g1, g2 = k7_grids(m, c, r, s)
    assert g1 == (cs, _cdiv(r, w1), _cdiv(m, k.ROWS))
    # phase 2: tiles of w2 columns of S, each CTA all of r
    _check_width(w2)
    assert g2 == (_cdiv(s, w2), _cdiv(m, k.ROWS))
    cols = np.zeros(s, dtype=np.int64)
    for tile in range(g2[0]):
        cols[tile * w2:min(tile * w2 + w2, s)] += 1
    assert (cols == 1).all()


@pytest.mark.parametrize("c,r,s", SERVED_K7)
def test_k7_fills_the_card_at_decode(c, r, s):
    """At M = 8 each phase launches at least one CTA per SM: the rank
    product is computed once a call, split over r and C, not once per
    column cluster on a fraction of the card."""
    g1, g2 = k7_grids(8, c, r, s)
    assert np.prod(g1) >= SMS and np.prod(g2) >= SMS
    assert np.prod(g1) <= 2 * SMS and np.prod(g2) <= 2 * SMS  # about one wave


def test_plans_raise_past_what_a_cluster_holds():
    with pytest.raises(ValueError, match="depth"):
        k.k6_plan(8, k.CHUNK * k.PER_MAX * k.CLUSTER_MAX + 1, 64, SMS)
    with pytest.raises(ValueError, match="depth"):
        k.k7_plan(8, k.CHUNK * k.PER_MAX * k.CLUSTER_MAX + 1, 16, 64, SMS)


# --------------------------------------------------------------------------
# The fragment layout of mma_step, emulated
# --------------------------------------------------------------------------

def mma_pos(kk):
    """Where k sits in the MMA order of its 16-deep group, in which the
    kernels store x and tq (csrc: value i of a 16-value item goes to byte
    i / 4 of word i % 4): k = 4 i + j at 4 j + i."""
    return (kk & ~15) | ((kk & 3) << 2) | ((kk >> 2) & 3)


def transpose4(words):
    """csrc transpose4 on four int32 words, as a 4 x 4 byte array."""
    b = np.array(words, dtype=np.uint32).view(np.uint8).reshape(4, 4)
    return b.T.copy().view(np.uint32).ravel()


def _word(buf, off):
    return int(buf[off:off + 4].view(np.uint32)[0])


@pytest.mark.parametrize("seed", [0, 1])
def test_fragment_layout_gives_the_product(seed):
    """One warp's mma_step over two k32 steps: A fragments read as 32-bit
    words of x in MMA order (a0/a1 rows g / g+8 at k 4t.., a2/a3 at 16 +
    4t..), B fragments from rows t, t+4, t+8, t+12 (+16) of a 32-byte-wide
    tile, transposed, and the accumulators stored as store_partial does,
    equal x @ B."""
    rng = np.random.default_rng(seed)
    kdim, lda = 64, 64 + 16
    x = rng.integers(-127, 128, (16, kdim), dtype=np.int8)
    b = rng.integers(-127, 128, (kdim, k.TILE), dtype=np.int8)
    xs = np.zeros((16, lda), dtype=np.int8)
    xs[:, [mma_pos(i) for i in range(kdim)]] = x
    # the int8 entry's prologue: the 4 x 4 transpose of each 16-byte group
    for grp in range(kdim // 16):
        words = x[:, grp * 16:grp * 16 + 16].copy().view(np.uint32)
        for row in range(16):
            got = transpose4(words[row]).view(np.int8)
            np.testing.assert_array_equal(got, xs[row, grp * 16:grp * 16 + 16])
    xf, bf = xs.view(np.uint8).ravel(), b.view(np.uint8).ravel()
    part = np.zeros((16, k.TILE), dtype=np.int64)
    for kx in range(0, kdim, 32):
        for f in range(4):
            a_mat = np.zeros((16, 32), dtype=np.int64)
            b_mat = np.zeros((32, 8), dtype=np.int64)
            for lane in range(32):
                g, t = divmod(lane, 4)
                for reg, (row, ko) in enumerate(((g, 0), (g + 8, 0), (g, 16), (g + 8, 16))):
                    a_mat[row, ko + 4 * t:ko + 4 * t + 4] = np.array(
                        [_word(xf, row * lda + kx + ko + 4 * t)], np.uint32).view(np.int8)
                for half in (0, 16):
                    rows = [kx + half + t + 4 * j for j in range(4)]
                    reg = transpose4([_word(bf, rr * k.TILE + 4 * g) for rr in rows])[f]
                    b_mat[half + 4 * t:half + 4 * t + 4, g] = np.array([reg], np.uint32).view(
                        np.int8)
            c = a_mat @ b_mat  # the MMA of n8 tile f; its column j is B's column 4 j + f
            for lane in range(32):
                g, t = divmod(lane, 4)
                part[g, 8 * t + f] += c[g, 2 * t]
                part[g, 8 * t + 4 + f] += c[g, 2 * t + 1]
                part[g + 8, 8 * t + f] += c[g + 8, 2 * t]
                part[g + 8, 8 * t + 4 + f] += c[g + 8, 2 * t + 1]
    np.testing.assert_array_equal(part, x.astype(np.int64) @ b.astype(np.int64))
