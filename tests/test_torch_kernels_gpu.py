"""The CUDA kernels against their plain versions, on a GPU (marked ``gpu``;
they skip without one: the kernels have no CPU mode).  No JAX here, so the
file runs on a machine that has only PyTorch:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_kernels_gpu.py
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels import ref
from repro_torch.kernels.lowrank_ffn import LARGE_M as K5_LARGE_M
from repro_torch.kernels.lowrank_ffn import lowrank_gated_ffn
from repro_torch.kernels.lowrank_matmul import LARGE_M as K1_LARGE_M
from repro_torch.kernels.lowrank_matmul import large_m, lowrank_matmul

torch.set_num_threads(1)

# max |kernel - plain| / max |plain| in bf16; chip_smoke.KERNEL_RTOL says why
K1_RTOL, K5_RTOL = 1e-2, 2e-2


def _mats(seed, *shapes):
    rng = np.random.default_rng(seed)
    out = [rng.standard_normal(shapes[0]).astype(np.float32)]
    for shape in shapes[1:]:
        out.append((rng.standard_normal(shape) / np.sqrt(shape[0])).astype(np.float32))
    return [torch.from_numpy(a).cuda().bfloat16() for a in out]


# --------------------------------------------------------------------------
# On the card: the CUDA kernels against their plain versions
# --------------------------------------------------------------------------

# the serving slice's (C, r, S) of K1 and (C, r, F) of K5, plus ragged edges;
# then the training paths' other geometries (the FFN recompute's gate/up,
# Algorithm-1 ranks 239/80/256), the largest rank the wrappers take, and a
# second ragged geometry
GPU_K1 = [(960, 240, 960), (960, 120, 320), (2560, 349, 960), (70, 5, 33),
          (960, 349, 2560), (960, 239, 960), (960, 80, 320), (960, 256, 2560),
          (2560, 256, 960), (960, 512, 960), (70, 17, 33)]
GPU_K5 = [(960, 349, 2560), (70, 17, 33), (960, 256, 2560), (960, 512, 2560)]
# decode design up to LARGE_M - 1, large-M design from LARGE_M: both sides of
# the threshold (K1's default; its table, large_m, moves it for C >= 2048 and
# r <= 128), the flash prefill's 2016, the train step's 2048 and a ragged 1000
GPU_K1_M = sorted({1, 8, 128, K1_LARGE_M - 1, K1_LARGE_M, 1000, 2016, 2048})
GPU_K5_M = sorted({1, 8, 128, K5_LARGE_M - 1, K5_LARGE_M, 1000, 2016, 2048})


def _need_gpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the kernels have no CPU mode")


@pytest.mark.gpu
@pytest.mark.parametrize("m", GPU_K1_M)
@pytest.mark.parametrize("c,r,s", GPU_K1)
def test_gpu_lowrank_matmul_matches_plain(m, c, r, s):
    _need_gpu()
    x, u, v = _mats(m + c, (m, c), (c, r), (r, s))
    with torch.inference_mode():
        got, want = lowrank_matmul(x, u, v), ref.lowrank_matmul_ref(x, u, v)
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs().max().item()
    assert err <= K1_RTOL * want.float().abs().max().item()


@pytest.mark.gpu
@pytest.mark.parametrize("m", GPU_K5_M)
@pytest.mark.parametrize("c,r,f", GPU_K5)
def test_gpu_lowrank_gated_ffn_matches_plain(m, c, r, f):
    _need_gpu()
    args = _mats(m + c, (m, c), (c, r), (r, f), (c, r), (r, f))
    with torch.inference_mode():
        got, want = lowrank_gated_ffn(*args), ref.lowrank_gated_ffn_ref(*args)
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs().max().item()
    assert err <= K5_RTOL * want.float().abs().max().item()


@pytest.mark.gpu
def test_gpu_wrappers_raise_instead_of_falling_back():
    _need_gpu()
    x = torch.zeros(4, 8, device="cuda")
    u, v = torch.zeros(8, 2, device="cuda"), torch.zeros(2, 3, device="cuda")
    with pytest.raises(TypeError, match="bfloat16"):
        lowrank_matmul(x, u, v)
    with pytest.raises(ValueError, match="not contiguous"):
        lowrank_matmul(x.bfloat16(), u.bfloat16().t().contiguous().t(), v.bfloat16())


@pytest.mark.gpu
@pytest.mark.parametrize("m", [8, 40, max(K1_LARGE_M, K5_LARGE_M), 2048])
def test_gpu_kernels_take_unaligned_operands(m):
    """Operands that do not start on a 16-byte boundary (a layer view of a
    stacked tensor can) take the element-load path and agree all the same,
    in the decode design and (from LARGE_M rows) the large-M design."""
    _need_gpu()
    c, r, s = 96, 24, 80

    def shifted(t):
        buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
        view = buf[1:].view(t.shape)
        view.copy_(t)
        return view

    x, u, v = (shifted(t) for t in _mats(m, (m, c), (c, r), (r, s)))
    gu, gv = (shifted(t) for t in _mats(m + 1, (1,), (c, r), (r, s))[1:])
    with torch.inference_mode():
        got, want = lowrank_matmul(x, u, v), ref.lowrank_matmul_ref(x, u, v)
        hg, hw = lowrank_gated_ffn(x, gu, gv, u, v), ref.lowrank_gated_ffn_ref(x, gu, gv, u, v)
    torch.cuda.synchronize()
    for a, b, rtol in ((got, want, K1_RTOL), (hg, hw, K5_RTOL)):
        err = (a.float() - b.float()).abs().max().item()
        assert err <= rtol * b.float().abs().max().item()


# --------------------------------------------------------------------------
# K2-K4: the backward kernels against their plain versions
# --------------------------------------------------------------------------

# max |kernel - plain| / max |plain|; the same rounding points as the plain
# versions, so chip_smoke.KERNEL_RTOL's reasoning for K1 holds
BWD_RTOL = 1e-2
# the training slice's (C, r, S): wq/wo, wk/wv, gate/up, down; then ragged;
# then the same projections at the Algorithm-1 ranks (239/80/256/256)
GPU_BWD = [(960, 240, 960), (960, 120, 320), (960, 349, 2560), (2560, 349, 960),
           (70, 5, 33), (33, 17, 70), (960, 239, 960), (960, 80, 320), (960, 256, 2560),
           (2560, 256, 960)]


def _bwd_case(name, m, c, r, s, mats=_mats):
    from repro_torch.kernels import lowrank_bwd as kb

    x, dy, u, v = mats(m + c + r, (m, c), (m, s), (c, r), (r, s))
    if name == "dx":
        return kb.lowrank_matmul_dx(dy, u, v), ref.lowrank_matmul_dx_ref(dy, u, v)
    if name == "du":
        return kb.lowrank_matmul_du(x, dy, v), ref.lowrank_matmul_du_ref(x, dy, v)
    return kb.lowrank_matmul_dv(x, u, dy), ref.lowrank_matmul_dv_ref(x, u, dy)


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["dx", "du", "dv"])
@pytest.mark.parametrize("m", [1, 8, 1000, 2048])
@pytest.mark.parametrize("c,r,s", GPU_BWD)
def test_gpu_lowrank_bwd_matches_plain(name, m, c, r, s):
    _need_gpu()
    got, want = _bwd_case(name, m, c, r, s)
    torch.cuda.synchronize()
    assert got.shape == want.shape and got.dtype == torch.bfloat16
    err = (got.float() - want.float()).abs().max().item()
    assert err <= BWD_RTOL * want.float().abs().max().item()


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["dx", "du", "dv"])
def test_gpu_lowrank_bwd_takes_unaligned_operands(name):
    """Operands off a 16-byte boundary (a layer view of a stacked factor)
    take the element-load path and agree all the same."""
    _need_gpu()

    def shifted(seed, *shapes):
        out = []
        for t in _mats(seed, *shapes):
            buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
            view = buf[1:].view(t.shape)
            view.copy_(t)
            out.append(view)
        return out

    got, want = _bwd_case(name, 300, 96, 24, 80, mats=shifted)
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs().max().item()
    assert err <= BWD_RTOL * want.float().abs().max().item()


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["du", "dv", "dx"])
@pytest.mark.parametrize("m,c,r,s", [(2048, 960, 120, 320), (2048, 2560, 349, 960),
                                     (2048, 960, 240, 960), (1000, 33, 17, 70)])
def test_gpu_lowrank_dudv_is_bitwise_repeatable(name, m, c, r, s):
    """K3/K4 split the sum over M and add the float32 partials in split
    order, never by atomics, and K2 splits no sum at all: two calls on the
    same inputs give the same bits (split_plan splits K3/K4's sums 1 to 16
    ways)."""
    _need_gpu()
    a, _ = _bwd_case(name, m, c, r, s)
    b, _ = _bwd_case(name, m, c, r, s)
    torch.cuda.synchronize()
    assert torch.equal(a, b)


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["du", "dv", "dx"])
def test_gpu_lowrank_dudv_same_scratch_twice_matches_plain(name):
    """Two calls in a row on different inputs through one scratch (what a
    CUDA graph's replay does) both match the plain version: nothing in the
    scratch carries over from one call to the next (K2: dt and the padded
    U at rank 349; K3/K4: also the split partials)."""
    _need_gpu()
    from repro_torch.kernels import lowrank_bwd as kb

    m, c, r, s = (2048, 960, 349, 320) if name == "dx" else (2048, 960, 120, 320)
    rows, cols = {"du": (c, r), "dv": (r, s), "dx": (m, c)}[name]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    if name == "dx":
        plan = kb.dx_plan(m, c, sms)
    else:
        plan = kb.split_plan(m, rows, cols, sms)
        assert plan > 1  # the partials go through the scratch
    scratch = None
    for seed in (11, 12):
        x, dy, u, v = _mats(seed, (m, c), (m, s), (c, r), (r, s))
        ops = {"du": (x, dy, v), "dv": (x, u, dy), "dx": (dy, u, v)}[name]
        want = {"du": ref.lowrank_matmul_du_ref, "dv": ref.lowrank_matmul_dv_ref,
                "dx": ref.lowrank_matmul_dx_ref}[name](*ops)
        if scratch is None:
            scratch = kb.bwd_scratch(name, ops, (m, c, r, s), plan)
        got = torch.empty((rows, cols), dtype=torch.bfloat16, device="cuda")
        kb._launch_bwd(name, ops, got, (m, c, r, s), plan, scratch)
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        assert err <= BWD_RTOL * want.float().abs().max().item()


@pytest.mark.gpu
@pytest.mark.parametrize("m,c,r,s", [(2048, 960, 240, 960), (2048, 2560, 349, 960),
                                     (300, 70, 17, 33), (2500, 960, 80, 320)])
def test_gpu_lowrank_dx_plan_and_one_cta_match_plain(m, c, r, s):
    """K2's phase 2 on its plan's grid and on one CTA that walks every
    tile: grids that walk several column tiles and, at M = 2500 and on one
    CTA, several row blocks a CTA."""
    _need_gpu()
    from repro_torch.kernels import lowrank_bwd as kb

    _, dy, u, v = _mats(m + 128, (1, 1), (m, s), (c, r), (r, s))
    want = ref.lowrank_matmul_dx_ref(dy, u, v)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for plan in (kb.dx_plan(m, c, sms), (1, 1)):  # the plan, and one CTA for all
        got = torch.empty((m, c), dtype=torch.bfloat16, device="cuda")
        kb._launch_bwd("dx", (dy, u, v), got, (m, c, r, s), plan)
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        assert err <= BWD_RTOL * want.float().abs().max().item(), plan


@pytest.mark.gpu
def test_gpu_lowrank_bwd_counts_launches_and_raises_instead_of_falling_back():
    _need_gpu()
    from repro_torch.kernels import lowrank_bwd as kb

    x, dy, u, v = _mats(3, (16, 40), (16, 24), (40, 8), (8, 24))
    before = (kb.lowrank_matmul_dx.launches, kb.lowrank_matmul_du.launches,
              kb.lowrank_matmul_dv.launches)
    kb.lowrank_matmul_dx(dy, u, v)
    kb.lowrank_matmul_du(x, dy, v)
    kb.lowrank_matmul_dv(x, u, dy)
    assert (kb.lowrank_matmul_dx.launches, kb.lowrank_matmul_du.launches,
            kb.lowrank_matmul_dv.launches) == tuple(n + 1 for n in before)
    assert kb.lowrank_matmul_du.launches_by_shape[(16, 40, 8, 24)] >= 1
    with pytest.raises(TypeError, match="bfloat16"):
        kb.lowrank_matmul_dx(dy.float(), u, v)
    with pytest.raises(ValueError, match="not contiguous"):
        kb.lowrank_matmul_du(x, dy.t().contiguous().t(), v)
    with pytest.raises(TypeError, match="bfloat16"):
        kb.lowrank_matmul_dv(x, u, dy, out_dtype=torch.float32)
    with pytest.raises(ValueError, match="chain"):
        kb.lowrank_matmul_dv(x, u, dy[:8])
    # a leaf that requires grad, under grad mode: the result would drop it
    with pytest.raises(ValueError, match="requires grad"):
        kb.lowrank_matmul_dx(dy, u.detach().clone().requires_grad_(True), v)
    with pytest.raises(ValueError, match="requires grad"):
        lowrank_matmul(x, u, v.detach().clone().requires_grad_(True))


@pytest.mark.gpu
@pytest.mark.parametrize("g", [None, 0, 1])
def test_gpu_autograd_launches_no_frozen_kernel_and_matches_plain(g):
    """lowrank_apply / lowrank_ffn_apply backward through K2-K4 with the
    policy on: the frozen factor's kernel is not launched, its gradient is
    None, and the others agree with the plain path's."""
    _need_gpu()
    from repro_torch.kernels import lowrank_bwd as kb
    from repro_torch.kernels import ops

    x, dy, u, v = _mats(g or 5, (256, 96), (256, 80), (96, 24), (24, 80))
    _, dyf, gu, gv = _mats(9, (1,), (256, 80), (96, 24), (24, 80))
    counts = {f: f.launches for f in (kb.lowrank_matmul_dx, kb.lowrank_matmul_du,
                                      kb.lowrank_matmul_dv)}
    grads = {}
    for use in (True, False):
        leaves = [t.detach().clone().requires_grad_(True) for t in (x, u, v, gu, gv)]
        lx, lu, lv, lgu, lgv = leaves
        y = ops.lowrank_apply(lx, lu, lv, use_kernel=use, freeze_group=g)
        h = ops.lowrank_ffn_apply(lx, lgu, lgv, lu, lv, use_kernel=use, freeze_group=g)
        torch.autograd.backward([y, h], [dy, dyf])
        grads[use] = [t.grad for t in leaves]
    torch.cuda.synchronize()
    launched = {f.__name__: f.launches - n for f, n in counts.items()}
    assert launched == {"lowrank_matmul_dx": 3, "lowrank_matmul_du": 0 if g == 0 else 3,
                        "lowrank_matmul_dv": 0 if g == 1 else 3}
    # x, u and v each sum the gradients of two calls, each within BWD_RTOL
    for k, p in zip(grads[True], grads[False]):
        assert (k is None) == (p is None)
        if k is not None:
            err = (k.float() - p.float()).abs().max().item()
            assert err <= 2 * BWD_RTOL * p.float().abs().max().item()
    assert (grads[True][1] is None) == (g == 0) and (grads[True][2] is None) == (g == 1)


# --------------------------------------------------------------------------
# K1-K5 at the ranks in-training rank adaptation gives the train step
# --------------------------------------------------------------------------

# decay 0.75 from the Eq.-5 ranks 240/120/349 gives 128/90/256 and then
# 96/67/128; from the Algorithm-1 ranks 239/80/256, 128/60/128 and then
# 96/45/96.  Each rank at every full-width (C, S) of the train step: ranks
# not a multiple of 8 give U a row pitch TMA cannot read (K1/K5's in-launch
# padding, K2-K4's padded copies)
ADAPTED_RANKS = [45, 60, 67, 90, 96, 128, 256]
ADAPTED_CS = [(960, 960), (960, 320), (960, 2560), (2560, 960)]


@pytest.mark.gpu
@pytest.mark.parametrize("m", sorted({K1_LARGE_M - 1, K1_LARGE_M, 2048}))
@pytest.mark.parametrize("r", ADAPTED_RANKS)
@pytest.mark.parametrize("c,s", ADAPTED_CS)
def test_gpu_lowrank_matmul_at_adapted_ranks(m, c, r, s):
    test_gpu_lowrank_matmul_matches_plain(m, c, r, s)


@pytest.mark.gpu
@pytest.mark.parametrize("m", sorted({K5_LARGE_M - 1, K5_LARGE_M, 2048}))
@pytest.mark.parametrize("r", ADAPTED_RANKS)
def test_gpu_lowrank_gated_ffn_at_adapted_ranks(m, r):
    test_gpu_lowrank_gated_ffn_matches_plain(m, 960, r, 2560)


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["dx", "du", "dv"])
@pytest.mark.parametrize("r", ADAPTED_RANKS)
@pytest.mark.parametrize("c,s", ADAPTED_CS)
def test_gpu_lowrank_bwd_at_adapted_ranks(name, c, r, s):
    test_gpu_lowrank_bwd_matches_plain(name, 2048, c, r, s)


@pytest.mark.gpu
def test_gpu_truncated_step_launches_no_frozen_factor_kernel():
    """Rank adaptation rewrites both factors of every group, the frozen one
    too; the steps after each boundary still launch no gradient kernel of
    the frozen factor (K3 at phase 0, K4 at phase 1), on the smoke model in
    bf16 with the kernels on."""
    _need_gpu()
    import dataclasses

    from repro_torch.core import rank_adapt
    from repro_torch.data import LMBatchIterator
    from repro_torch.kernels import lowrank_bwd as kb
    from repro_torch.launch import steps, train

    run = train.build_run(train._parser().parse_args(
        ["--smoke", "--lrd", "--lrd-min-dim", "16", "--no-rank-opt", "--use-pallas",
         "--freeze", "sequential", "--rank-schedule", "decay", "--global-batch", "2",
         "--seq-len", "64"]))
    run = dataclasses.replace(run, model=dataclasses.replace(
        run.model, param_dtype="bfloat16", compute_dtype="bfloat16"))
    params, _ = steps.init_params(run, "cuda")
    state, parked = steps.make_train_state(run.optim, params, 0)
    step = steps.build_train_step(run, "cuda")
    batches = iter(LMBatchIterator(run.model.vocab_size, 64, 2, seed=0))
    state, _ = step(state, next(batches), phase=0)
    schedule = rank_adapt.schedule_from_config(run.lrd)
    kernels = {"dx": kb.lowrank_matmul_dx, "du": kb.lowrank_matmul_du,
               "dv": kb.lowrank_matmul_dv}
    n = 7 * run.model.num_layers  # factor groups a step
    for boundary, phase in ((1, 1), (2, 0)):
        before = rank_adapt.live_rank_map(state.params)
        state, parked = steps.repartition_state(run.optim, state, parked, phase,
                                                schedule=schedule, boundary=boundary)
        after = rank_adapt.live_rank_map(state.params)
        assert all(after[p] < before[p] for p in before), (before, after)
        counts = {k: f.launches for k, f in kernels.items()}
        state, metrics = step(state, next(batches), phase=phase)
        torch.cuda.synchronize()
        assert np.isfinite(metrics["loss"].item())
        launched = {k: f.launches - counts[k] for k, f in kernels.items()}
        assert launched == {"dx": n, "du": 0 if phase == 0 else n, "dv": 0 if phase == 1 else n}


# --------------------------------------------------------------------------
# K6-K7: the int8 decode kernels against their plain versions
# --------------------------------------------------------------------------

# the int8 export's (C, S) at full width (wq/wo, wk/wv, gate/up, down), then
# ragged edges (C and S not multiples of 16, S not of 64)
GPU_INT8_CS = [(960, 960), (960, 320), (960, 2560), (2560, 960), (70, 33), (100, 1000)]
# K7's ranks: the analytic export's 119/128/256 and the Eq.-5 349
GPU_K7_R = [119, 128, 256, 349]
# max |K7 - plain| / max |plain|: every step is an exact integer sum or one
# IEEE float32 operation in the same order, so the two should agree bit for bit
K7_RTOL = 1e-6


def _int8_mats(seed, *shapes):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.integers(-127, 128, s, dtype=np.int8)).cuda() for s in shapes]


def _scales(seed, n):
    rng = np.random.default_rng(seed)
    return torch.from_numpy((rng.uniform(0.5, 1.5, (1, n)) * 1e-2).astype(np.float32)).cuda()


def _k7_args(m, c, r, s, seed=0):
    x_q, u_q, v_q = _int8_mats(seed + m + c + r + s, (m, c), (c, r), (r, s))
    return x_q, u_q, _scales(seed + 1, r), v_q, _scales(seed + 2, s)


@pytest.mark.gpu
@pytest.mark.parametrize("m", [1, 8, 128, 2048])
@pytest.mark.parametrize("c,s", GPU_INT8_CS)
def test_gpu_int8_matmul_is_exact(m, c, s):
    _need_gpu()
    from repro_torch.kernels.int8_matmul import int8_matmul

    x_q, w_q = _int8_mats(m + c + s, (m, c), (c, s))
    got = int8_matmul(x_q, w_q)
    want = ref.int8_matmul_ref(x_q, w_q)
    torch.cuda.synchronize()
    assert got.dtype == torch.int32 and torch.equal(got, want)


@pytest.mark.gpu
@pytest.mark.parametrize("m", [1, 8, 128, 2048])
@pytest.mark.parametrize("r", GPU_K7_R)
@pytest.mark.parametrize("c,s", GPU_INT8_CS[:5])
def test_gpu_int8_lowrank_matches_plain(m, r, c, s):
    _need_gpu()
    from repro_torch.kernels.int8_matmul import int8_lowrank_matmul

    args = _k7_args(m, c, r, s)
    got = int8_lowrank_matmul(*args)
    want = ref.int8_lowrank_matmul_ref(*args)
    torch.cuda.synchronize()
    assert got.dtype == torch.float32 and got.shape == (m, s)
    err = (got - want).abs().max().item()
    assert err <= K7_RTOL * want.abs().max().item()


def _shifted(t):
    """A copy of t one element past a 16-byte boundary (a layer view of a
    stacked tensor can lie so)."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    view = buf[1:].view(t.shape)
    view.copy_(t)
    return view


# the serving entries: x (bf16 on the serve path, float32 too) quantized in
# the kernel, the scales applied there, output in x's dtype
GPU_X_DTYPES = [torch.bfloat16, torch.float32]


def _x(m, c, dtype, seed=0):
    rng = np.random.default_rng(seed + m + c)
    x = rng.standard_normal((m, c)).astype(np.float32)
    x[0, : c // 3] = 0.0  # a partly zero row
    if m > 2:
        x[-1] = 0.0  # an all-zero row: the scale floor
    return torch.from_numpy(x).cuda().to(dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", GPU_X_DTYPES)
@pytest.mark.parametrize("m", [1, 8, 128, 2048])
@pytest.mark.parametrize("c,s", GPU_INT8_CS)
def test_gpu_int8_linear_matches_plain_bitwise(m, c, s, dtype):
    _need_gpu()
    from repro_torch.kernels.int8_matmul import int8_linear

    x = _x(m, c, dtype)
    (w_q,) = _int8_mats(c + s, (c, s))
    ws = _scales(s, s)
    got = int8_linear(x, w_q, ws)
    want = ref.int8_linear_ref(x, w_q, ws)
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == (m, s) and torch.equal(got, want)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", GPU_X_DTYPES)
@pytest.mark.parametrize("m", [1, 8, 128, 2048])
@pytest.mark.parametrize("r", GPU_K7_R)
@pytest.mark.parametrize("c,s", GPU_INT8_CS)
def test_gpu_int8_lowrank_linear_matches_plain(m, r, c, s, dtype):
    _need_gpu()
    from repro_torch.kernels.int8_matmul import int8_lowrank_linear

    x = _x(m, c, dtype)
    _, u_q, us, v_q, vs = _k7_args(1, c, r, s, seed=m)
    got = int8_lowrank_linear(x, u_q, us, v_q, vs)
    want = ref.int8_lowrank_linear_ref(x, u_q, us, v_q, vs)
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == (m, s)
    err = (got.float() - want.float()).abs().max().item()
    assert err <= K7_RTOL * want.float().abs().max().item()


# K7 past its old ceiling of 512: the first rank past it, Zamba2's serve
# ranks 640 and 1280, the VLM's 1920 and 3072, and the ceiling
GPU_K7_WIDE_R = [513, 640, 1280, 1920, 3072, 4096]


@pytest.mark.gpu
@pytest.mark.parametrize("m", [8, 2048])
@pytest.mark.parametrize("r", GPU_K7_WIDE_R)
@pytest.mark.parametrize("entry", ["int8", "linear"])
def test_gpu_int8_lowrank_past_rank_512_bitwise(entry, r, m):
    """Both entries of K7 past r = 512, where the out kernel requantizes in
    pieces of 512 ranks: bit for bit against the plain version at decode
    (M = 8) and at an 8 x 256 prefill (M = 2048)."""
    _need_gpu()
    from repro_torch.kernels.int8_matmul import int8_lowrank_linear, int8_lowrank_matmul

    c, s = 1024, 1000
    x_q, u_q, us, v_q, vs = _k7_args(m, c, r, s)
    if entry == "int8":
        got = int8_lowrank_matmul(x_q, u_q, us, v_q, vs)
        want = ref.int8_lowrank_matmul_ref(x_q, u_q, us, v_q, vs)
    else:
        x = _x(m, c, torch.bfloat16, seed=r)
        got = int8_lowrank_linear(x, u_q, us, v_q, vs)
        want = ref.int8_lowrank_linear_ref(x, u_q, us, v_q, vs)
    torch.cuda.synchronize()
    assert got.shape == (m, s) and got.dtype == want.dtype
    assert torch.equal(got, want)


@pytest.mark.gpu
@pytest.mark.parametrize("fused", [False, True])
def test_gpu_int8_lowrank_same_scratch_twice_matches_plain(fused):
    """K7 twice through one scratch, filled with garbage first, on
    different x: both match the plain version (each launch writes all of
    t and the x scales before phase 2 reads them; nothing carries over)."""
    _need_gpu()
    from repro_torch.kernels import int8_matmul as k

    m, c, r, s = 8, 960, 119, 320
    _, u_q, us, v_q, vs = _k7_args(1, c, r, s, seed=21)
    scratch = k.k7_scratch(m, r, "cuda")
    scratch.copy_(torch.randint(-2 ** 31, 2 ** 31 - 1, scratch.shape, dtype=torch.int32))
    for seed in (22, 23):
        if fused:
            x = _x(m, c, torch.bfloat16, seed=seed)
            want = ref.int8_lowrank_linear_ref(x, u_q, us, v_q, vs)
            xtype, dtype = 2, torch.bfloat16
        else:
            (x,) = _int8_mats(seed, (m, c))
            want = ref.int8_lowrank_matmul_ref(x, u_q, us, v_q, vs)
            xtype, dtype = 0, torch.float32
        got = torch.empty((m, s), dtype=dtype, device="cuda")
        k._k7("int8_lowrank_linear", xtype, x, u_q, us, v_q, vs, got, scratch)
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        assert err <= K7_RTOL * want.float().abs().max().item()


@pytest.mark.gpu
def test_gpu_int8_dispatch_runs_no_torch_quantizer(monkeypatch):
    """On CUDA tensors ops.int8_apply / int8_lowrank_apply quantize inside
    the kernels: with every quantize_rowwise the port has made to raise,
    they still run, launch one fused kernel entry each, and match the plain
    versions computed before."""
    _need_gpu()
    from repro_torch.kernels import int8_matmul as k
    from repro_torch.kernels import ops

    x = _mats(6, (2, 4, 960))[0]
    (w_q,) = _int8_mats(31, (960, 320))
    ws = _scales(32, 320)
    _, u_q, us, v_q, vs = _k7_args(1, 960, 119, 320, seed=33)
    want_d = ref.int8_linear_ref(x.reshape(8, 960), w_q, ws).reshape(2, 4, 320)
    want_l = ref.int8_lowrank_linear_ref(x.reshape(8, 960), u_q, us, v_q, vs).reshape(2, 4, 320)

    def boom(*a, **kw):
        raise AssertionError("a torch quantizer ran on the kernel path")

    for mod in (ops, ref, k):
        if hasattr(mod, "quantize_rowwise"):
            monkeypatch.setattr(mod, "quantize_rowwise", boom)
    before = (k.int8_linear.launches, k.int8_lowrank_linear.launches)
    yd = ops.int8_apply(x, w_q, ws, use_kernel=True)
    yl = ops.int8_lowrank_apply(x, u_q, us, v_q, vs, use_kernel=True)
    torch.cuda.synchronize()
    assert (k.int8_linear.launches, k.int8_lowrank_linear.launches) == (before[0] + 1,
                                                                         before[1] + 1)
    assert torch.equal(yd, want_d)
    err = (yl.float() - want_l.float()).abs().max().item()
    assert err <= K7_RTOL * want_l.float().abs().max().item()


class _StandInMesh:
    """A (1, model) mesh at coordinate ``(0, i)``, read as the dispatch reads
    a ``DeviceMesh`` (axis names, shape, coordinate): the sharded serving
    step's context on one process."""

    def __init__(self, model: int, i: int):
        self.mesh_dim_names, self.shape, self._i = ("data", "model"), (1, model), i

    def get_coordinate(self):
        return [0, self._i]


# the serving mesh's model axes: 5 KV heads on 2 ranks (pool replicated) and
# on 5 (one head a rank); every int8 S of smollm-360m divides both
GPU_INT8_MODEL = [2, 5]


@pytest.mark.gpu
@pytest.mark.parametrize("model", GPU_INT8_MODEL)
@pytest.mark.parametrize("m", [8, 128])
@pytest.mark.parametrize("c,s", GPU_INT8_CS[:4])
def test_gpu_int8_dispatch_on_column_blocks_is_bitwise(c, s, m, model, monkeypatch):
    """Under a serving mesh with w_q / v_q registered as this rank's columns,
    ``ops.int8_apply`` launches K6 and ``ops.int8_lowrank_apply`` K7 on the
    local block (never the plain path: no fallback is recorded) and hands
    the block to the column gather, which here returns it as it is: each
    rank's block is bit for bit the matching columns of the unsharded call,
    since x is quantized per row, and K7's t requantized per row, before
    any column is split."""
    _need_gpu()
    from repro_torch.distributed import collectives
    from repro_torch.distributed.sharding import axis_rules
    from repro_torch.kernels import int8_matmul as k
    from repro_torch.kernels import ops

    x = _x(m, c, torch.bfloat16)
    (w_q,) = _int8_mats(c + s, (c, s))
    ws = _scales(s, s)
    _, u_q, us, v_q, vs = _k7_args(1, c, 128, s, seed=m)
    whole_d = ops.int8_apply(x, w_q, ws, use_kernel=True)
    whole_l = ops.int8_lowrank_apply(x, u_q, us, v_q, vs, use_kernel=True)
    gathered = []

    def gather(t, mesh, axes, dim, *, path):
        gathered.append((tuple(axes), dim, path))
        return t

    monkeypatch.setattr(collectives, "all_gather", gather)
    w = s // model
    for i in range(model):
        cols = slice(i * w, (i + 1) * w)
        blocks = [t[:, cols].contiguous() for t in (w_q, ws, v_q, vs)]
        leaves = {p: (t, True) for p, t in zip(("w_q", "w_scale", "v_q", "v_scale"), blocks)}
        before = (k.int8_linear.launches, k.int8_lowrank_linear.launches)
        with ops.capture_fallbacks() as fb, axis_rules(_StandInMesh(model, i), rows=(),
                                                       leaves=leaves):
            yd = ops.int8_apply(x, blocks[0], blocks[1], use_kernel=True)
            yl = ops.int8_lowrank_apply(x, u_q, us, blocks[2], blocks[3], use_kernel=True)
        torch.cuda.synchronize()
        assert not fb
        assert (k.int8_linear.launches, k.int8_lowrank_linear.launches) == (before[0] + 1,
                                                                             before[1] + 1)
        assert torch.equal(yd, whole_d[:, cols]) and torch.equal(yl, whole_l[:, cols])
    assert gathered == [(("model",), 1, "activation")] * (2 * model)


@pytest.mark.gpu
def test_gpu_int8_kernels_take_unaligned_operands():
    """Operands off a 16-byte boundary take the element-load path and agree
    all the same, through both entries of each kernel."""
    _need_gpu()
    from repro_torch.kernels.int8_matmul import (int8_linear, int8_lowrank_linear,
                                                 int8_lowrank_matmul, int8_matmul)

    x_q, u_q, us, v_q, vs = _k7_args(40, 96, 24, 80, seed=3)
    xs, uq2, vq2 = _shifted(x_q), _shifted(u_q), _shifted(v_q)
    assert torch.equal(int8_matmul(xs, uq2), ref.int8_matmul_ref(x_q, u_q))
    got = int8_lowrank_matmul(xs, uq2, us, vq2, vs)
    want = ref.int8_lowrank_matmul_ref(x_q, u_q, us, v_q, vs)
    torch.cuda.synchronize()
    assert (got - want).abs().max().item() <= K7_RTOL * want.abs().max().item()
    for dtype in (torch.bfloat16, torch.float32):
        x = _mats(5, (40, 96))[0].to(dtype)
        x2, us2 = _shifted(x), _shifted(us)
        assert torch.equal(int8_linear(x2, uq2, us2), ref.int8_linear_ref(x, u_q, us))
        got = int8_lowrank_linear(x2, uq2, us2, vq2, vs)
        want = ref.int8_lowrank_linear_ref(x, u_q, us, v_q, vs)
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        assert err <= K7_RTOL * want.float().abs().max().item()


@pytest.mark.gpu
def test_gpu_int8_wrappers_count_launches_and_raise_instead_of_falling_back():
    _need_gpu()
    from repro_torch.kernels.int8_matmul import int8_lowrank_matmul, int8_matmul

    x_q, u_q, us, v_q, vs = _k7_args(8, 64, 16, 40, seed=4)
    before = (int8_matmul.launches, int8_lowrank_matmul.launches)
    int8_matmul(x_q, u_q)
    int8_lowrank_matmul(x_q, u_q, us, v_q, vs)
    assert (int8_matmul.launches, int8_lowrank_matmul.launches) == (before[0] + 1,
                                                                     before[1] + 1)
    assert int8_matmul.launches_by_shape[(8, 64, 16)] >= 1
    assert int8_lowrank_matmul.launches_by_shape[(8, 64, 16, 40)] >= 1
    with pytest.raises(TypeError, match="int8"):
        int8_matmul(x_q.float(), u_q)
    with pytest.raises(TypeError, match="float32"):
        int8_lowrank_matmul(x_q, u_q, us.double(), v_q, vs)
    with pytest.raises(ValueError, match="operands on"):  # a CPU operand
        int8_matmul(x_q, u_q.cpu())
    with pytest.raises(ValueError, match="operands on"):
        int8_lowrank_matmul(x_q, u_q, us, v_q.cpu(), vs)
    with pytest.raises(ValueError, match="not contiguous"):
        int8_matmul(x_q, u_q.t().contiguous().t())
    with pytest.raises(ValueError, match="want"):
        int8_matmul(x_q, v_q)
    big = _k7_args(8, 64, 4097, 40)
    with pytest.raises(ValueError, match="rank 4097 .*item 13"):
        int8_lowrank_matmul(*big)
    # the serving entries: x float32 or bf16, counted by shape
    from repro_torch.kernels.int8_matmul import int8_linear, int8_lowrank_linear

    x = _mats(4, (8, 64))[0]
    before = (int8_linear.launches, int8_lowrank_linear.launches)
    int8_linear(x, u_q, us)
    int8_lowrank_linear(x, u_q, us, v_q, vs)
    assert (int8_linear.launches, int8_lowrank_linear.launches) == (before[0] + 1,
                                                                     before[1] + 1)
    assert int8_linear.launches_by_shape[(8, 64, 16)] >= 1
    assert int8_lowrank_linear.launches_by_shape[(8, 64, 16, 40)] >= 1
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        int8_linear(x.half(), u_q, us)
    with pytest.raises(TypeError, match="int8"):
        int8_lowrank_linear(x, u_q.float(), us, v_q, vs)
    with pytest.raises(ValueError, match="w_scale"):
        int8_linear(x, u_q, vs)
    with pytest.raises(ValueError, match="rank 4097 .*item 13"):
        int8_lowrank_linear(x, *big[1:])


@pytest.mark.gpu
def test_gpu_int8_dispatch_launches_the_kernels():
    """ops.int8_apply / int8_lowrank_apply with the kernel requested launch
    K6 / K7's serving entries on CUDA tensors (no plain-version decision
    recorded, no int8-operand entry) and give the algebra the CPU path
    computes with the plain versions."""
    _need_gpu()
    from repro_torch.kernels import ops
    from repro_torch.kernels.int8_matmul import (int8_linear, int8_lowrank_linear,
                                                 int8_lowrank_matmul, int8_matmul,
                                                 quantize_colwise)

    x = _mats(6, (2, 4, 96))[0]
    w_q, w_s = quantize_colwise(_mats(7, (1,), (96, 40))[1])
    u_q, u_s = quantize_colwise(_mats(8, (1,), (96, 24))[1])
    v_q, v_s = quantize_colwise(_mats(9, (1,), (24, 40))[1])
    wrappers = (int8_linear, int8_lowrank_linear, int8_matmul, int8_lowrank_matmul)
    before = [w.launches for w in wrappers]
    with ops.capture_fallbacks() as fbs:
        yd = ops.int8_apply(x, w_q, w_s, use_kernel=True)
        yl = ops.int8_lowrank_apply(x, u_q, u_s, v_q, v_s, use_kernel=True)
    torch.cuda.synchronize()
    assert not fbs
    assert [w.launches for w in wrappers] == [before[0] + 1, before[1] + 1, before[2],
                                              before[3]]
    cpu = [t.cpu() for t in (x, w_q, w_s, u_q, u_s, v_q, v_s)]
    wd = ops.int8_apply(*cpu[:3], use_kernel=True)
    wl = ops.int8_lowrank_apply(cpu[0], *cpu[3:], use_kernel=True)
    for got, want in ((yd, wd), (yl, wl)):
        assert got.dtype == torch.bfloat16 and got.shape == (2, 4, 40)
        err = (got.cpu().float() - want.float()).abs().max().item()
        # the same int32 sums and float32 steps; the bf16 output rounding
        # of two equal float32 values is equal
        assert err <= K7_RTOL * want.float().abs().max().item()


# --------------------------------------------------------------------------
# OLMoE-1B-7B's attention projections at Eq.-5 ranks: (C, r, S) = (2048,
# 512, 2048), r at the old ceiling; M = 8 (8-slot decode), 128 (a prefill) and
# 2048 (8 x 256 train tokens)
# --------------------------------------------------------------------------

OLMOE_ATTN = (2048, 512, 2048)
OLMOE_M = [8, 128, 2048]


@pytest.mark.gpu
@pytest.mark.parametrize("m", OLMOE_M)
def test_gpu_lowrank_matmul_at_olmoe_attention(m):
    _need_gpu()
    c, r, s = OLMOE_ATTN
    x, u, v = _mats(m + 7, (m, c), (c, r), (r, s))
    with torch.inference_mode():
        got, want = lowrank_matmul(x, u, v), ref.lowrank_matmul_ref(x, u, v)
        again = lowrank_matmul(x, u, v)
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs().max().item()
    assert err <= K1_RTOL * want.float().abs().max().item()
    # activation checkpointing recomputes the forward and relies on this
    assert torch.equal(got, again)


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["dx", "du", "dv"])
@pytest.mark.parametrize("m", OLMOE_M)
def test_gpu_lowrank_bwd_at_olmoe_attention(name, m):
    _need_gpu()
    got, want = _bwd_case(name, m, *OLMOE_ATTN)
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs().max().item()
    assert err <= BWD_RTOL * want.float().abs().max().item()


# --------------------------------------------------------------------------
# K1/K5's decode design (M below LARGE_M): fixed-order sums, no state
# across calls
# --------------------------------------------------------------------------

DECODE_K1 = [(960, 240, 960), (2560, 349, 960), (960, 59, 320), (2048, 512, 2048),
             (4096, 1365, 8192), (4096, 682, 2048)]
DECODE_K5 = [(960, 349, 2560), (960, 128, 2560)]


def _decode_case(name, m, dims, seed):
    c, r, s = dims
    if name == "k1":
        x, u, v = _mats(seed, (m, c), (c, r), (r, s))
        return x, (u, v), lowrank_matmul, ref.lowrank_matmul_ref, K1_RTOL
    x, gu, gv, uu, uv = _mats(seed, (m, c), (c, r), (r, s), (c, r), (r, s))
    return x, (gu, gv, uu, uv), lowrank_gated_ffn, ref.lowrank_gated_ffn_ref, K5_RTOL


def _decode_params():
    return ([("k1", d) for d in DECODE_K1] + [("k5", d) for d in DECODE_K5])


@pytest.mark.gpu
@pytest.mark.parametrize("m", [1, 8, 40])
@pytest.mark.parametrize("name,dims", _decode_params())
def test_gpu_decode_design_is_bitwise_repeatable(name, dims, m):
    """No float atomics: the cluster's partials meet in rank order, so two
    calls on the same inputs give the same bits (and agree with plain)."""
    _need_gpu()
    x, w, fn, plain, rtol = _decode_case(name, m, dims, m + 3)
    with torch.inference_mode():
        got, again, want = fn(x, *w), fn(x, *w), plain(x, *w)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    err = (got.float() - want.float()).abs().max().item()
    assert err <= rtol * want.float().abs().max().item()


@pytest.mark.gpu
@pytest.mark.parametrize("name,dims", _decode_params())
def test_gpu_decode_rows_do_not_depend_on_m(name, dims):
    """A row has the same bits at M = 8 as inside M = 16, 24, 40 and
    LARGE_M - 1, first or last: the split of C is the plan's, never M's
    (speculative decoding's verify leans on it)."""
    _need_gpu()
    x8, w, fn, _, _ = _decode_case(name, 8, dims, 11)
    lm = large_m(dims[0], dims[1]) if name == "k1" else K5_LARGE_M
    with torch.inference_mode():
        want = fn(x8, *w)
        for m in (16, 24, 40, lm - 1):
            other = _mats(m, (m - 8, dims[0]))[0]
            assert torch.equal(fn(torch.cat([x8, other]), *w)[:8], want), m
            assert torch.equal(fn(torch.cat([other, x8]), *w)[-8:], want), m


@pytest.mark.gpu
@pytest.mark.parametrize("m", sorted({1, 8, 128, large_m(*OLMOE_ATTN[:2]) - 1}))
def test_gpu_lowrank_matmul_decode_design_at_olmoe_attention(m):
    """OLMoE's (2048, 512, 2048): r = 512, the last rank in one phase-2
    piece of the decode design."""
    _need_gpu()
    c, r, s = OLMOE_ATTN
    x, u, v = _mats(m + 5, (m, c), (c, r), (r, s))
    with torch.inference_mode():
        got, want = lowrank_matmul(x, u, v), ref.lowrank_matmul_ref(x, u, v)
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs().max().item()
    assert err <= K1_RTOL * want.float().abs().max().item()


@pytest.mark.gpu
@pytest.mark.parametrize("m", [1, 8, 40, K1_LARGE_M - 1])
@pytest.mark.parametrize("c,r,s", [(960, 349, 960), (70, 17, 33), (100, 59, 200)])
def test_gpu_decode_design_takes_unaligned_operands(m, c, r, s):
    """Odd ranks (rows of U off 16 bytes) and operands one element off a
    16-byte boundary take the shifted-load path below LARGE_M."""
    _need_gpu()

    def shifted(t):
        buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
        view = buf[1:].view(t.shape)
        view.copy_(t)
        return view

    x, u, v = (shifted(t) for t in _mats(m + r, (m, c), (c, r), (r, s)))
    gu, gv = (shifted(t) for t in _mats(m + r + 1, (1,), (c, r), (r, s))[1:])
    with torch.inference_mode():
        got, want = lowrank_matmul(x, u, v), ref.lowrank_matmul_ref(x, u, v)
        hg, hw = lowrank_gated_ffn(x, gu, gv, u, v), ref.lowrank_gated_ffn_ref(x, gu, gv, u, v)
    torch.cuda.synchronize()
    for a, b, rtol in ((got, want, K1_RTOL), (hg, hw, K5_RTOL)):
        err = (a.float() - b.float()).abs().max().item()
        assert err <= rtol * b.float().abs().max().item()


@pytest.mark.gpu
def test_gpu_decode_design_replays_in_a_cuda_graph():
    """One K1 and one K5 decode-design call captured in a CUDA graph and
    replayed twice on new x match the plain versions both times: the
    launches keep nothing across calls (the scratch comes from the graph's
    pool and is written before it is read)."""
    _need_gpu()
    x1, u, v = _mats(21, (8, 2560), (2560, 349), (349, 960))
    x5, gu, gv, uu, uv = _mats(22, (8, 960), (960, 349), (349, 2560), (960, 349), (349, 2560))
    with torch.inference_mode():
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):  # warm up (and build) off the capture
            lowrank_matmul(x1, u, v)
            lowrank_gated_ffn(x5, gu, gv, uu, uv)
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            y1 = lowrank_matmul(x1, u, v)
            y5 = lowrank_gated_ffn(x5, gu, gv, uu, uv)
        for seed in (23, 24):
            x1.copy_(_mats(seed, (8, 2560))[0])
            x5.copy_(_mats(seed + 10, (8, 960))[0])
            graph.replay()
            torch.cuda.synchronize()
            for got, want, rtol in ((y1, ref.lowrank_matmul_ref(x1, u, v), K1_RTOL),
                                    (y5, ref.lowrank_gated_ffn_ref(x5, gu, gv, uu, uv),
                                     K5_RTOL)):
                err = (got.float() - want.float()).abs().max().item()
                assert err <= rtol * want.float().abs().max().item()


# --------------------------------------------------------------------------
# K1-K4 past rank 512: Zamba2-1.2B's factorised projections at Eq.-5 ranks
# (mamba in_proj, out_proj / shared down_proj, the shared attention, the
# shared FFN's wi and down) and Algorithm-1 ranks, the first rank past the
# old ceiling and the new one.  M = 8 (8-row decode), 128 (decode design,
# one row block) and 2048 (8 x 256 train tokens, the large-M design).
# --------------------------------------------------------------------------

ZAMBA_EQ5 = [(2048, 822, 8384), (4096, 682, 2048), (4096, 1024, 4096), (4096, 1365, 8192),
             (8192, 1365, 4096)]
ZAMBA_ALG1 = [(2048, 640, 8384), (4096, 640, 2048), (4096, 896, 4096), (4096, 1280, 8192)]
RANK_EDGES = [(960, 513, 960), (4096, 2048, 4096)]
WIDE_M = [8, 128, 2048]


@pytest.mark.gpu
@pytest.mark.parametrize("m", WIDE_M)
@pytest.mark.parametrize("c,r,s", ZAMBA_EQ5 + ZAMBA_ALG1 + RANK_EDGES)
def test_gpu_lowrank_matmul_past_rank_512(m, c, r, s):
    """Both designs walk the rank (decode: pieces of at most 512 rows;
    large-M: passes of 128 columns of t, t streamed with V), one float32 sum
    and one rounding an output; the same bits on a second call."""
    _need_gpu()
    x, u, v = _mats(m + r, (m, c), (c, r), (r, s))
    with torch.inference_mode():
        got, want = lowrank_matmul(x, u, v), ref.lowrank_matmul_ref(x, u, v)
        again = lowrank_matmul(x, u, v)
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs().max().item()
    assert err <= K1_RTOL * want.float().abs().max().item()
    assert torch.equal(got, again)


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["dx", "du", "dv"])
@pytest.mark.parametrize("c,r,s", ZAMBA_EQ5 + ZAMBA_ALG1 + RANK_EDGES)
def test_gpu_lowrank_bwd_past_rank_512(name, c, r, s):
    """K2 streams dt through its ring past r = 512; K3/K4 gain output tiles
    along r.  M = 2048 (8 x 256 train tokens); bitwise repeatable."""
    _need_gpu()
    got, want = _bwd_case(name, 2048, c, r, s)
    again, _ = _bwd_case(name, 2048, c, r, s)
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs().max().item()
    assert err <= BWD_RTOL * want.float().abs().max().item()
    assert torch.equal(got, again)


@pytest.mark.gpu
def test_gpu_rank_ceilings():
    """K1-K5 and K7 take r up to 4096 and refuse 4097, naming ROADMAP item
    13."""
    _need_gpu()
    from repro_torch.kernels import int8_matmul as k7
    from repro_torch.kernels import lowrank_bwd as kb

    x, u, v = _mats(1, (8, 64), (64, 4097), (4097, 32))
    with pytest.raises(ValueError, match="rank 4097 .*item 13"):
        lowrank_matmul(x, u, v)
    with pytest.raises(ValueError, match="rank 4097 .*item 13"):
        kb.lowrank_matmul_dx(torch.zeros_like(x[:, :32]), u, v)
    with pytest.raises(ValueError, match="4097.*item 13"):
        lowrank_gated_ffn(x, u, v, u, v)
    x, u, v = _mats(2, (8, 64), (64, 4096), (4096, 32))
    with torch.inference_mode():
        got, want = lowrank_gated_ffn(x, u, v, u, v), ref.lowrank_gated_ffn_ref(x, u, v, u, v)
    torch.cuda.synchronize()
    assert (got.float() - want.float()).abs().max() <= K5_RTOL * want.float().abs().max()
    for r in (4096, 4097):
        uq = torch.ones((64, r), dtype=torch.int8, device="cuda")
        vq = torch.ones((r, 32), dtype=torch.int8, device="cuda")
        ones = [torch.ones(s, dtype=torch.float32, device="cuda") for s in ((1, r), (1, 32))]
        if r == 4097:
            with pytest.raises(ValueError, match="rank 4097 .*item 13"):
                k7.int8_lowrank_linear(x, uq, ones[0], vq, ones[1])
            continue
        got = k7.int8_lowrank_linear(x, uq, ones[0], vq, ones[1])
        torch.cuda.synchronize()
        assert torch.equal(got, ref.int8_lowrank_linear_ref(x, uq, ones[0], vq, ones[1]))


# --------------------------------------------------------------------------
# K1-K4 past rank 2048 and K5 past 512: the VLM's geometries
# (llama-3.2-vision-90b, d 8192, 64 heads of 128, 8 KV heads, SwiGLU 28672;
# Eq.-5 ranks 2048 wq/wo, 455 wk/wv, 3185 FFN), the large dense configs'
# FFNs at their Eq.-5 ranks (qwen3-32b, deepseek-coder-33b, qwen2-72b,
# DeepSeek-V3's dense layers), the first rank past each old ceiling and the
# new one.  M = 8 (8-slot decode), 128 (decode design), LARGE_M - 1, 2048
# (8 x 256 train tokens, the large-M design) and 32768 (the cross k/v of 8
# x 4096 image tokens).
# --------------------------------------------------------------------------

VLM_ATTN = [(8192, 2048, 8192), (8192, 455, 1024)]
VLM_FFN = (8192, 3185, 28672)
DENSE_FFN = [(5120, 2133, 25600), (7168, 2609, 19200), (8192, 3207, 29568), (7168, 2580, 18432)]
WIDE_K1 = (VLM_ATTN + [VLM_FFN, (28672, 3185, 8192)] + [(f, r, c) for c, r, f in DENSE_FFN]
           + [(960, 2049, 960), (4096, 4096, 4096)])
WIDE_K5 = [VLM_FFN] + DENSE_FFN + [(960, 513, 960), (4096, 4096, 4096)]


def _close_rel(got, want, rtol):
    err = (got.float() - want.float()).abs().max().item()
    assert err <= rtol * want.float().abs().max().item(), err


@pytest.mark.gpu
@pytest.mark.parametrize("m", [8, 128, 2048])
@pytest.mark.parametrize("c,r,s", WIDE_K1)
def test_gpu_lowrank_matmul_past_rank_2048(m, c, r, s):
    """Both designs at the VLM's and the large dense configs' geometries:
    one float32 sum and one rounding an output; the same bits on a second
    call."""
    _need_gpu()
    x, u, v = _mats(m + r, (m, c), (c, r), (r, s))
    with torch.inference_mode():
        got, want = lowrank_matmul(x, u, v), ref.lowrank_matmul_ref(x, u, v)
        again = lowrank_matmul(x, u, v)
    torch.cuda.synchronize()
    _close_rel(got, want, K1_RTOL)
    assert torch.equal(got, again)


@pytest.mark.gpu
def test_gpu_lowrank_matmul_at_vlm_cross_kv():
    """The cross blocks' wk/wv on 8 x 4096 image tokens (M 32768, the
    large-M design) against plain."""
    _need_gpu()
    c, r, s = VLM_ATTN[1]
    x, u, v = _mats(7, (32768, c), (c, r), (r, s))
    with torch.inference_mode():
        got, want = lowrank_matmul(x, u, v), ref.lowrank_matmul_ref(x, u, v)
    torch.cuda.synchronize()
    _close_rel(got, want, K1_RTOL)


@pytest.mark.gpu
@pytest.mark.parametrize("m", sorted({8, 128, K5_LARGE_M - 1, K5_LARGE_M, 2048}))
@pytest.mark.parametrize("c,r,f", WIDE_K5)
def test_gpu_lowrank_gated_ffn_past_rank_512(m, c, r, f):
    """K5 walks both branches' ranks in pieces (decode design) or passes
    with t streamed through the ring (large-M design), silu(g) * u on the
    whole float32 sums; the same bits on a second call."""
    _need_gpu()
    args = _mats(m + c + r, (m, c), (c, r), (r, f), (c, r), (r, f))
    with torch.inference_mode():
        got, want = lowrank_gated_ffn(*args), ref.lowrank_gated_ffn_ref(*args)
        again = lowrank_gated_ffn(*args)
    torch.cuda.synchronize()
    _close_rel(got, want, K5_RTOL)
    assert torch.equal(got, again)


@pytest.mark.gpu
@pytest.mark.parametrize("m", [8, 2048])
@pytest.mark.parametrize("rg,ru", [(513, 700), (3185, 2048), (1000, 4096)])
def test_gpu_lowrank_gated_ffn_unequal_branch_ranks(m, rg, ru):
    """Branches of different ranks past 512: the smaller one reads zeros
    past its own rank in every piece and pass."""
    _need_gpu()
    c, f = 1024, 2048
    args = _mats(m + rg + ru, (m, c), (c, rg), (rg, f), (c, ru), (ru, f))
    with torch.inference_mode():
        got, want = lowrank_gated_ffn(*args), ref.lowrank_gated_ffn_ref(*args)
    torch.cuda.synchronize()
    _close_rel(got, want, K5_RTOL)


@pytest.mark.gpu
@pytest.mark.parametrize("name,dims", [("k1", VLM_FFN), ("k1", (28672, 3185, 8192)),
                                       ("k1", VLM_ATTN[0]), ("k5", VLM_FFN),
                                       ("k5", (4096, 4096, 4096))])
def test_gpu_decode_rows_do_not_depend_on_m_past_rank_2048(name, dims):
    """A row has the same bits at M = 8 as inside M = 16, 40 and the
    design's threshold - 1, first or last, past the old ceilings too: the
    split of C and the rank's pieces are set by the shape, never by M."""
    _need_gpu()
    x8, w, fn, _, _ = _decode_case(name, 8, dims, 13)
    lm = large_m(dims[0], dims[1]) if name == "k1" else K5_LARGE_M
    with torch.inference_mode():
        want = fn(x8, *w)
        for m in (16, 40, lm - 1):
            other = _mats(m, (m - 8, dims[0]))[0]
            assert torch.equal(fn(torch.cat([x8, other]), *w)[:8], want), m
            assert torch.equal(fn(torch.cat([other, x8]), *w)[-8:], want), m


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["dx", "du", "dv"])
@pytest.mark.parametrize("c,r,s", WIDE_K1)
def test_gpu_lowrank_bwd_past_rank_2048(name, c, r, s):
    """K2-K4 at M = 2048 (8 x 256 train tokens) at the same geometries;
    bitwise repeatable."""
    _need_gpu()
    got, want = _bwd_case(name, 2048, c, r, s)
    again, _ = _bwd_case(name, 2048, c, r, s)
    torch.cuda.synchronize()
    _close_rel(got, want, BWD_RTOL)
    assert torch.equal(got, again)


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["dx", "du", "dv"])
def test_gpu_lowrank_bwd_at_vlm_cross_kv(name):
    """K2-K4 on the cross blocks' wk/wv over 8 x 4096 image tokens."""
    _need_gpu()
    got, want = _bwd_case(name, 32768, *VLM_ATTN[1])
    torch.cuda.synchronize()
    _close_rel(got, want, BWD_RTOL)


# --------------------------------------------------------------------------
# The enc-dec family's geometries (seamless-m4t-medium, d 1024, FFN 4096):
# Eq.-5 ranks 256 / 409 (the serve path), Algorithm-1 ranks 255 / 384 (the
# train path); M = 8 (decode, 8 slots), 2048 (8 x 256 decoder tokens) and
# 8192 (the cross k/v projections of 8 x 1024 encoder frames)
# --------------------------------------------------------------------------

ENCDEC_ATTN = [(1024, 256, 1024), (1024, 255, 1024)]
ENCDEC_FFN = [(1024, 409, 4096), (4096, 409, 1024), (1024, 384, 4096), (4096, 384, 1024)]


@pytest.mark.gpu
@pytest.mark.parametrize("m,c,r,s", [(m, c, r, s) for m in (8, 2048, 8192)
                                     for c, r, s in ENCDEC_ATTN]
                         + [(m, c, r, s) for m in (8, 2048) for c, r, s in ENCDEC_FFN])
def test_gpu_lowrank_matmul_at_encdec_geometry(m, c, r, s):
    """K1 at the enc-dec paths' geometries, the odd rank 255 and 409 among
    them (U padded inside the launch); the decode design's bits again on a
    second call."""
    _need_gpu()
    x, u, v = _mats(m + r + s, (m, c), (c, r), (r, s))
    with torch.inference_mode():
        got, want = lowrank_matmul(x, u, v), ref.lowrank_matmul_ref(x, u, v)
        again = lowrank_matmul(x, u, v)
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs().max().item()
    assert err <= K1_RTOL * want.float().abs().max().item()
    if m < large_m(c, r):
        assert torch.equal(got, again)


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["dx", "du", "dv"])
@pytest.mark.parametrize("m,c,r,s", [(2048, c, r, s) for c, r, s in ENCDEC_ATTN + ENCDEC_FFN]
                         + [(8192, 1024, 255, 1024), (8192, 1024, 256, 1024)])
def test_gpu_lowrank_bwd_at_encdec_geometry(name, m, c, r, s):
    """K2-K4 at the enc-dec train step's geometries (M 8192: the cross k/v
    projections of the memory); bitwise repeatable."""
    _need_gpu()
    got, want = _bwd_case(name, m, c, r, s)
    again, _ = _bwd_case(name, m, c, r, s)
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs().max().item()
    assert err <= BWD_RTOL * want.float().abs().max().item()
    assert torch.equal(got, again)


# --------------------------------------------------------------------------
# DeepSeek-V3's geometries at Eq.-5 ranks (d 7168, 128 heads; MLA q_up
# 1536 -> 128 x 192 at rank 722, kv_up 512 -> 128 x 256 at 252, wo 16384 ->
# 7168 at 2493; the dense FFN 7168 <-> 18432 at 2580; the shared expert
# 7168 <-> 2048 at 796; mtp/proj 14336 -> 7168 at 2389).  K1 on every
# factorised projection (gate/up too: the FFN backward's recompute), K5 on
# the dense FFN's and the shared expert's gate/up.  M = 8 (8-slot decode),
# 24 and 40 (the speculative verify chunks of k = 2 and 4), 256 (a
# scheduler prefill of one 256-token prompt) and 2048 (8 x 256 train or
# batched prefill tokens).
# --------------------------------------------------------------------------

MLA_K1 = [(1536, 722, 24576), (512, 252, 32768), (16384, 2493, 7168), (18432, 2580, 7168),
          (2048, 796, 7168), (14336, 2389, 7168), (7168, 2580, 18432), (7168, 796, 2048)]
MLA_K5 = [(7168, 2580, 18432), (7168, 796, 2048)]
MLA_M = (8, 24, 40, 256, 2048)


@pytest.mark.gpu
@pytest.mark.parametrize("m", MLA_M)
@pytest.mark.parametrize("c,r,s", MLA_K1)
def test_gpu_lowrank_matmul_at_mla_geometry(m, c, r, s):
    """K1 at DeepSeek-V3's geometries against plain; the same bits on a
    second call."""
    _need_gpu()
    x, u, v = _mats(m + r + s, (m, c), (c, r), (r, s))
    with torch.inference_mode():
        got, want = lowrank_matmul(x, u, v), ref.lowrank_matmul_ref(x, u, v)
        again = lowrank_matmul(x, u, v)
    torch.cuda.synchronize()
    _close_rel(got, want, K1_RTOL)
    assert torch.equal(got, again)


@pytest.mark.gpu
@pytest.mark.parametrize("m", MLA_M)
@pytest.mark.parametrize("c,r,f", MLA_K5)
def test_gpu_lowrank_gated_ffn_at_mla_geometry(m, c, r, f):
    """K5 at the dense FFN's and the shared expert's gate/up against plain;
    the same bits on a second call."""
    _need_gpu()
    args = _mats(m + c + r, (m, c), (c, r), (r, f), (c, r), (r, f))
    with torch.inference_mode():
        got, want = lowrank_gated_ffn(*args), ref.lowrank_gated_ffn_ref(*args)
        again = lowrank_gated_ffn(*args)
    torch.cuda.synchronize()
    _close_rel(got, want, K5_RTOL)
    assert torch.equal(got, again)


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["dx", "du", "dv"])
@pytest.mark.parametrize("c,r,s", MLA_K1)
def test_gpu_lowrank_bwd_at_mla_geometry(name, c, r, s):
    """K2-K4 at the train step's M = 2048 on every factor pair of the
    one-dense-layer cut with its MTP layer; bitwise repeatable."""
    _need_gpu()
    got, want = _bwd_case(name, 2048, c, r, s)
    again, _ = _bwd_case(name, 2048, c, r, s)
    torch.cuda.synchronize()
    _close_rel(got, want, BWD_RTOL)
    assert torch.equal(got, again)


# --------------------------------------------------------------------------
# The autotuner's candidates (kernels/autotune.py) at smollm-360m's
# geometries: every design, plan, split and grid it may pick there, through
# the wrappers' keywords, against the plain versions
# --------------------------------------------------------------------------

TUNE_GEOMS = [(960, 240, 960), (960, 120, 320), (2560, 349, 960), (960, 349, 2560)]
TUNE_M = [8, 128, 256, 320, 2048]


def _sms():
    from repro_torch.kernels.lowrank_matmul import sm_count
    return sm_count(torch.cuda.current_device())


def _tune_candidates(op, m, c, r, s):
    from repro_torch.analysis import roofline
    from repro_torch.kernels import autotune

    return roofline.prune_choices(op, m, c, r, s, autotune.candidates(op, m, c, r, s, _sms()))


@pytest.mark.gpu
@pytest.mark.parametrize("m", TUNE_M)
@pytest.mark.parametrize("c,r,s", TUNE_GEOMS)
def test_gpu_tuned_lowrank_matmul_choices_match_plain(m, c, r, s):
    """Every K1 candidate (the large design from 64 rows, the decode
    design under decode_plan and its neighbours) at K1_RTOL."""
    _need_gpu()
    x, u, v = _mats(m + c + r, (m, c), (c, r), (r, s))
    with torch.inference_mode():
        want = ref.lowrank_matmul_ref(x, u, v)
        for ch in _tune_candidates("lowrank_fwd", m, c, r, s):
            got = lowrank_matmul(x, u, v, **ch.kwargs())
            torch.cuda.synchronize()
            _close_rel(got, want, K1_RTOL)


@pytest.mark.gpu
@pytest.mark.parametrize("m", TUNE_M)
def test_gpu_tuned_lowrank_gated_ffn_choices_match_plain(m):
    _need_gpu()
    c, r, f = 960, 349, 2560
    args = _mats(m + c + r, (m, c), (c, r), (r, f), (c, r), (r, f))
    with torch.inference_mode():
        want = ref.lowrank_gated_ffn_ref(*args)
        for ch in _tune_candidates("lowrank_ffn", m, c, r, f):
            got = lowrank_gated_ffn(*args, **ch.kwargs())
            torch.cuda.synchronize()
            _close_rel(got, want, K5_RTOL)


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["dx", "du", "dv"])
@pytest.mark.parametrize("c,r,s", TUNE_GEOMS)
def test_gpu_tuned_bwd_choices_match_plain(name, c, r, s):
    """Every K2 plan and K3/K4 split the tuner may pick at the train step's
    M = 2048; a split sums in its own fixed order, so bitwise repeatable."""
    from repro_torch.kernels import lowrank_bwd as kb

    _need_gpu()
    m = 2048
    x, dy, u, v = _mats(m + c + r, (m, c), (m, s), (c, r), (r, s))
    fn, plain, args = {"dx": (kb.lowrank_matmul_dx, ref.lowrank_matmul_dx_ref, (dy, u, v)),
                       "du": (kb.lowrank_matmul_du, ref.lowrank_matmul_du_ref, (x, dy, v)),
                       "dv": (kb.lowrank_matmul_dv, ref.lowrank_matmul_dv_ref, (x, u, dy))}[name]
    want = plain(*args)
    for ch in _tune_candidates("lowrank_" + name, m, c, r, s):
        got = fn(*args, **ch.kwargs())
        again = fn(*args, **ch.kwargs())
        torch.cuda.synchronize()
        _close_rel(got, want, BWD_RTOL)
        assert torch.equal(got, again), ch


@pytest.mark.gpu
@pytest.mark.parametrize("sq", [17, 2016])
def test_gpu_tuned_flash_grids_match_plain(sq):
    """Every K8 grid the tuner may pick at the 2016-token prefill (15 heads
    over 5 kv heads, D 64), row by row within 1e-2 of the row's max, as
    chip_smoke.KERNEL_RTOL holds K8; the grid only deals units out, so
    every grid gives the same bits."""
    from repro_torch.kernels.flash_attention import flash_attention

    _need_gpu()
    h, kvh, d = 15, 5, 64
    q, k, v = _mats(sq, (1, sq, h, d), (1, sq, kvh, d), (1, sq, kvh, d))
    with torch.inference_mode():
        want = ref.flash_attention_fwd_ref(q, k, v, causal=True).float()
        outs = []
        for ch in _tune_candidates("flash", sq, h, d, sq):
            got = flash_attention(q, k, v, causal=True, **ch.kwargs()).float()
            torch.cuda.synchronize()
            rows = (got - want).abs().amax(dim=-1) / want.abs().amax(dim=-1).clamp_min(1e-30)
            assert rows.max().item() <= 1e-2, ch
            outs.append(got)
    assert all(torch.equal(o, outs[0]) for o in outs)


@pytest.mark.gpu
@pytest.mark.parametrize("op,c,r,s", [("lowrank_fwd", *g) for g in TUNE_GEOMS]
                         + [("lowrank_ffn", 960, 349, 2560)])
def test_gpu_tuned_decode_plan_keeps_a_rows_bits_across_m(op, c, r, s):
    """A decode plan the tuner may share across buckets gives each row the
    same bits at M 8 as inside M 128: the plan, not M, orders the sums."""
    _need_gpu()
    x = _mats(c + r, (128, c))[0]
    mats = _mats(r + s, (c, r), (r, s), (c, r), (r, s))
    fn = lowrank_matmul if op == "lowrank_fwd" else lowrank_gated_ffn
    w = mats[:2] if op == "lowrank_fwd" else mats
    plans = {ch for m in (8, 128) for ch in _tune_candidates(op, m, c, r, s)
             if ch.design == "decode"}
    assert plans
    with torch.inference_mode():
        for ch in sorted(plans, key=lambda ch: ch.plan):
            y128 = fn(x, *w, **ch.kwargs())
            y8 = fn(x[:8].contiguous(), *w, **ch.kwargs())
            torch.cuda.synchronize()
            assert torch.equal(y128[:8], y8), ch
