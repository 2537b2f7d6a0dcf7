"""K6's and K7's launch plans (``kernels/int8_matmul.py``: ``k6_plan``,
``k7_plan``, which the wrappers pass to the kernels), checked on the CPU
against a mirror of the CUDA kernels' grids and index math (``csrc/int8_matmul.cu``,
``gemm_body`` and ``k7_out_kernel``): every output element and every
128-row chunk of C is covered exactly once, every CTA of a cluster has a
chunk, a CTA's slab of x fits in shared memory, and K7 at M = 8 fills the
card in both phases; K7 past rank 512 (to 4096, at M up to 32768), its
requantization's walk over pieces of 512 ranks and its phase-2 shared
memory; the depth past which an int32 sum could wrap.  Also the kernels' fragment layout, emulated in numpy:
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


# K7 past rank 512, (C, r, S): the analytic int8 export's serve ranks at
# full width (Zamba2-1.2B: Mamba2 in_proj and out_proj, the shared block's
# attention, down and FFN; llama-3.2-vision-90b: q/o, k/v, gate/up, down;
# seamless-m4t-medium's FFN), the first rank past 512 and the ceiling
WIDE_K7 = [(2048, 768, 8384), (4096, 640, 2048), (4096, 896, 4096), (4096, 1280, 8192),
           (8192, 1280, 4096), (8192, 1920, 8192), (8192, 384, 1024), (8192, 3072, 28672),
           (28672, 3072, 8192), (1024, 384, 4096), (1000, 513, 1000), (4096, 4096, 4096)]
# decode slots, an 8 x 256 prefill, enc-dec's cross k/v over 8 x 1024
# frames, the VLM's over 8 x 4096 image tokens
WIDE_MS = [8, 2048, 8192, 32768]
GRID_MAX = 65535  # the y and z dimensions of a grid


def out_smem(r):
    """Dynamic shared memory of k7_out_kernel (csrc out_smem): v's tile of
    out_rows(r) x 32 bytes, the tq slab of 16 rows of r_pad + 16 (128-byte
    aligned), the four warps' partial sums, the row scales, x scales and
    v_scale, the mbarrier."""
    rk = _cdiv(r, 32) * 32
    rows = _cdiv(rk, k.CHUNK) * k.CHUNK
    return (rows * k.TILE + _cdiv(k.ROWS * (rk + 16), 128) * 128
            + 4 * 4 * k.ROWS * k.TILE + 4 * (2 * k.ROWS + k.TILE) + 16)


def piece_walk(r):
    """Mirror of k7_out_kernel's requantization walk for one row: its 8
    threads (cg), kHold = 4 items of 16 ranks each, pieces of PIECE ranks.
    Returns how often the max pass reads each rank of [0, r) and how often
    the quantize pass writes each column of the padded slab [0, r_pad)."""
    rk = _cdiv(r, 32) * 32
    pieces = _cdiv(rk, k.PIECE)
    read = np.zeros(r, dtype=np.int64)
    written = np.zeros(rk, dtype=np.int64)
    for p in range(pieces):
        for cg in range(8):
            for j in range(4):
                c0 = p * k.PIECE + (cg + 8 * j) * 16
                for i in range(16):
                    if c0 + i < r:
                        read[c0 + i] += 1
                if c0 < rk:
                    written[c0:c0 + 16] += 1
    return read, written, pieces


def _check_split(m, c, n, w, cs, per):
    """gemm_body's cover, one axis at a time (the full (M, N, chunks)
    count does not fit in memory at these sizes; the map is a product of
    its three axes): row blocks, tiles of w columns and the cluster's
    chunks each cover their axis once."""
    _check_width(w)
    assert 1 <= cs <= k.CLUSTER_MAX and 1 <= per <= k.PER_MAX
    chunks = _cdiv(c, k.CHUNK)
    for size, step, count in ((m, k.ROWS, _cdiv(m, k.ROWS)), (n, w, _cdiv(n, w)),
                              (chunks, per, cs)):
        hits = np.zeros(size, dtype=np.int64)
        for i in range(count):
            hits[i * step:min(i * step + step, size)] += 1
        assert (hits == 1).all()
    assert (cs - 1) * per < chunks  # every CTA of a cluster has a chunk
    assert gemm_smem(per) <= SMEM_MAX


@pytest.mark.parametrize("m", WIDE_MS)
@pytest.mark.parametrize("c,r,s", WIDE_K7)
def test_k7_plan_past_rank_512(m, c, r, s):
    """Both phases at every r up to 4096 and M up to 32768: every output,
    column tile and chunk covered once, both grids within CUDA's limits,
    both phases' shared memory under 227 KB, the t scratch within int32
    indexing."""
    (w1, cs, per), w2 = k.k7_plan(m, c, r, s, SMS)
    _check_split(m, c, r, w1, cs, per)
    g1, g2 = k7_grids(m, c, r, s)
    assert max(g1[1:]) <= GRID_MAX and max(g2[1:]) <= GRID_MAX
    _check_width(w2)
    cols = np.zeros(s, dtype=np.int64)
    for tile in range(g2[0]):
        cols[tile * w2:min(tile * w2 + w2, s)] += 1
    assert (cols == 1).all()
    assert out_smem(r) <= SMEM_MAX
    assert m * r + m <= 2 ** 31 - 1  # k7_scratch


@pytest.mark.parametrize("r", [1, 119, 512, 513, 640, 1000, 1280, 1920, 3072, 4095, 4096])
def test_k7_piece_walk_covers_the_rank_once(r):
    """The max pass reads every rank once, the quantize pass writes every
    column of the slab the MMA reads (r padded to 32; zeros past r) once,
    in pieces of 512; one piece up to r = 512, so those ranks stay in
    registers between the passes."""
    read, written, pieces = piece_walk(r)
    assert (read == 1).all() and (written == 1).all()
    assert pieces == _cdiv(_cdiv(r, 32) * 32, 512)
    assert (pieces == 1) == (r <= 512)
    assert out_smem(r) <= SMEM_MAX
    assert out_smem(4096) > 200 * 1024  # the ceiling's v tile and slab: 201 KB


@pytest.mark.parametrize("c,r,s", WIDE_K7[:9])
def test_k7_fills_the_card_at_decode_past_rank_512(c, r, s):
    """At M = 8 the rank product's tiles of r and the cluster split give at
    least one CTA an SM, and so do phase 2's tiles of S."""
    g1, g2 = k7_grids(8, c, r, s)
    assert np.prod(g1) >= SMS and np.prod(g2) >= SMS


def test_wrappers_refuse_a_depth_whose_sum_could_wrap():
    """|sum| <= C * 127**2 must stay below 2**31: both wrappers (both
    entries each) take C = 133144 and refuse C = 133145 before touching a
    device (meta tensors), rather than return a wrapped sum.  A call they
    take is priced on the meta device (``lowrank_matmul.priced``)."""
    assert k.DEPTH_MAX == 133144
    assert k.DEPTH_MAX * 127 ** 2 < 2 ** 31 <= (k.DEPTH_MAX + 1) * 127 ** 2

    def meta(shape, dtype):
        return torch.empty(shape, dtype=dtype, device="meta")

    for c in (k.DEPTH_MAX, k.DEPTH_MAX + 1):
        xq, x = meta((8, c), torch.int8), meta((8, c), torch.bfloat16)
        w, ws = meta((c, 64), torch.int8), meta((1, 64), torch.float32)
        u, us = meta((c, 16), torch.int8), meta((1, 16), torch.float32)
        v = meta((16, 64), torch.int8)
        calls = ((k.int8_matmul, (xq, w)), (k.int8_linear, (x, w, ws)),
                 (k.int8_lowrank_matmul, (xq, u, us, v, ws)),
                 (k.int8_lowrank_linear, (x, u, us, v, ws)))
        for fn, args in calls:
            if c > k.DEPTH_MAX:
                with pytest.raises(ValueError, match=f"depth {c} .*wrap"):
                    fn(*args)
            else:  # past the depth check: taken, and priced on the meta device
                before = sum(fn.priced_by_shape.values())
                y = fn(*args)
                assert y.device.type == "meta" and tuple(y.shape) == (8, 64)
                assert sum(fn.priced_by_shape.values()) == before + 1


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
