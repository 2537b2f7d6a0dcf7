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
from repro_torch.kernels.lowrank_matmul import lowrank_matmul

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
# the threshold, the flash prefill's 2016, the train step's 2048 and a
# ragged 1000
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
    big = _k7_args(8, 64, 513, 40)
    with pytest.raises(ValueError, match="rank 513"):
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
    with pytest.raises(ValueError, match="rank 513"):
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
