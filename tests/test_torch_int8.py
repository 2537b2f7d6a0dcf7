"""The port's int8 pieces against the JAX package on the same seeded numpy
inputs: the quantizers (bitwise), the plain versions of K6 (exact against
``int8_matmul(..., interpret=True)``) and K7 (within 1e-5 of
``int8_lowrank_matmul(..., interpret=True)`` and of a numpy emulation of
its algebra), the serving entries' plain versions (``int8_linear``,
``int8_lowrank_linear``: the quantizer inside the kernel) against JAX's
dispatchers at the export's full widths, the dispatchers ``int8_apply`` /
``int8_lowrank_apply`` with the kernel requested (the CPU runs the
kernel's plain version) and with the policy off (the weight-only
formula), and ``models.common.linear`` on int8 groups in both decode
modes."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels.int8_matmul import int8_lowrank_matmul as j_k7
from repro.kernels.int8_matmul import int8_matmul as j_k6
from repro.kernels.int8_matmul import quantize_colwise as j_qcol
from repro.kernels.int8_matmul import quantize_rowwise as j_qrow
from repro.models import common as jcommon
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref
from repro_torch.kernels.int8_matmul import int8_linear as t_k6_linear
from repro_torch.kernels.int8_matmul import int8_lowrank_linear as t_k7_linear
from repro_torch.kernels.int8_matmul import int8_lowrank_matmul as t_k7
from repro_torch.kernels.int8_matmul import int8_matmul as t_k6
from repro_torch.kernels.int8_matmul import quantize_colwise as t_qcol
from repro_torch.kernels.int8_matmul import quantize_rowwise as t_qrow
from repro_torch.models import common as tcommon

torch.set_num_threads(1)

# K7 output tolerance against JAX's interpret-mode kernel and the numpy
# emulation (as tests/test_int8_decode.py states it): every step is an exact
# integer sum or one float32 operation, so only the backends' float32
# rounding of the same operations can differ
K7_TOL = 1e-5


def _normal(seed, shape, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(16, 64), (5, 119), (3, 40, 24)])
def test_quantizers_match_jax_bitwise(dtype, shape):
    a = _normal(sum(shape), shape, 0.3)
    a[0, ..., 0] = 0.0  # a zero row / column somewhere
    if len(shape) == 2:
        a[-1] = 0.0  # an all-zero row: the scale floor
    ja = jnp.asarray(a, dtype=dtype)
    ta = torch.from_numpy(a).to(getattr(torch, dtype))
    for jq, tq in ((j_qrow, t_qrow), (j_qcol, t_qcol)):
        jv, js = jq(ja)
        tv, ts = tq(ta)
        assert tv.dtype == torch.int8 and ts.dtype == torch.float32
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
        np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


@pytest.mark.parametrize("m,c,s,blocks", [(128, 256, 128, (128, 128, 128)),
                                          (16, 64, 32, (16, 64, 32)),
                                          (8, 960, 64, (8, 192, 64))])
def test_int8_matmul_plain_is_exact(m, c, s, blocks):
    rng = np.random.default_rng(m + c + s)
    a = rng.integers(-127, 128, (m, c), dtype=np.int8)
    b = rng.integers(-127, 128, (c, s), dtype=np.int8)
    got = ref.int8_matmul_ref(_t(a), _t(b))
    bm, bk, bn = blocks
    want = np.asarray(j_k6(jnp.asarray(a), jnp.asarray(b), block_m=bm, block_k=bk,
                           block_n=bn, interpret=True))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(want, a.astype(np.int64) @ b.astype(np.int64))
    # the wrapper takes CPU tensors through the plain version, launching nothing
    n = t_k6.launches
    np.testing.assert_array_equal(t_k6(_t(a), _t(b)).numpy(), want)
    assert t_k6.launches == n


def _emulate_k7(x_q, u_q, u_s, v_q, v_s):
    """numpy emulation of the fused kernel's algebra (tests/test_int8_decode.py)."""
    t = (x_q.astype(np.int32) @ u_q.astype(np.int32)).astype(np.float32) * u_s
    ts = np.maximum(np.abs(t).max(-1, keepdims=True), 1e-8) / 127.0
    tq = np.clip(np.round(t / ts), -127, 127)
    return (tq @ v_q.astype(np.int32).astype(np.float64)).astype(np.float32) * ts * v_s


@pytest.mark.parametrize("m,c,r,s,blocks", [(128, 256, 64, 128, (128, 128, 128)),
                                            (16, 64, 119, 32, (16, 64, 32)),
                                            (8, 128, 349, 64, (8, 64, 64))])
def test_int8_lowrank_plain_matches_jax_and_emulation(m, c, r, s, blocks):
    x = _normal(1, (m, c))
    u = _normal(2, (c, r), c ** -0.5)
    v = _normal(3, (r, s), r ** -0.5)
    x_q, x_s = j_qrow(jnp.asarray(x))
    u_q, u_s = j_qcol(jnp.asarray(u))
    v_q, v_s = j_qcol(jnp.asarray(v))
    bm, bk, bn = blocks
    want = np.asarray(j_k7(x_q, u_q, u_s, v_q, v_s, block_m=bm, block_k=bk, block_n=bn,
                           interpret=True))
    args = [_t(a) for a in (x_q, u_q, u_s, v_q, v_s)]
    got = ref.int8_lowrank_matmul_ref(*args).numpy()
    emu = _emulate_k7(*(np.asarray(a) for a in (x_q, u_q, u_s, v_q, v_s)))
    scale = np.abs(want).max()
    for other in (got, emu):
        np.testing.assert_allclose(other, want, atol=K7_TOL * scale, rtol=K7_TOL)
    n = t_k7.launches
    np.testing.assert_array_equal(t_k7(*args).numpy(), got)
    assert t_k7.launches == n


# the int8 export's (C, S) at full width (wq/wo, wk/wv, gate/up, down) and
# the analytic export's ranks
FULL_CS = [(960, 960), (960, 320), (960, 2560), (2560, 960)]
FULL_R = [119, 128, 256]


def _full_case(seed, c, s, dtype, r=None):
    """x (2, 4, C) from a numpy seed in ``dtype`` (JAX and torch), and the
    int8 export of a (C, S) weight or a (C, r), (r, S) factor pair."""
    x = _normal(seed, (2, 4, c))
    jx = jnp.asarray(x, dtype=dtype)
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    if r is None:
        leaves = j_qcol(jnp.asarray(_normal(seed + 1, (c, s), c ** -0.5)))
    else:
        leaves = (j_qcol(jnp.asarray(_normal(seed + 1, (c, r), c ** -0.5)))
                  + j_qcol(jnp.asarray(_normal(seed + 2, (r, s), r ** -0.5))))
    return jx, tx, leaves


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("c,s", FULL_CS)
def test_int8_linear_plain_matches_jax_bitwise(dtype, c, s):
    """K6's serving entry (quantizer and scales inside the kernel) as its
    plain version computes it, against JAX's dispatcher on its kernel path
    (interpret mode, one block): the same quantizer, an exact int32 sum and
    the same two float32 products, so the same bits."""
    jx, tx, (w_q, w_s) = _full_case(c + s, c, s, dtype)
    want = jops.int8_apply(jx, w_q, w_s, use_kernel=True, interpret=True, block_m=8,
                           block_k=c, block_n=s)
    got = ref.int8_linear_ref(tx.reshape(8, c), _t(w_q), _t(w_s))
    assert got.dtype == getattr(torch, dtype)
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want.astype(jnp.float32)).reshape(8, s))
    n = t_k6_linear.launches  # CPU tensors: the wrapper runs the plain version
    assert torch.equal(t_k6_linear(tx.reshape(8, c), _t(w_q), _t(w_s)), got)
    assert t_k6_linear.launches == n


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("r", FULL_R)
@pytest.mark.parametrize("c,s", FULL_CS)
def test_int8_lowrank_linear_plain_matches_jax(dtype, r, c, s):
    """K7's serving entry's plain version against JAX's dispatcher on its
    kernel path, within K7_TOL of max |y| in float32 (one bf16 ulp, 2**-8,
    in bf16, where a last-bit float32 difference can flip the rounding)."""
    jx, tx, (u_q, u_s, v_q, v_s) = _full_case(c + r + s, c, s, dtype, r)
    want = np.asarray(jops.int8_lowrank_apply(
        jx, u_q, u_s, v_q, v_s, use_kernel=True, interpret=True, block_m=8, block_k=c,
        block_n=s).astype(jnp.float32)).reshape(8, s)
    args = [_t(a) for a in (u_q, u_s, v_q, v_s)]
    got = ref.int8_lowrank_linear_ref(tx.reshape(8, c), *args)
    assert got.dtype == getattr(torch, dtype)
    tol = K7_TOL if dtype == "float32" else 2 ** -8
    np.testing.assert_allclose(got.float().numpy(), want, atol=tol * np.abs(want).max(),
                               rtol=tol)
    n = t_k7_linear.launches
    assert torch.equal(t_k7_linear(tx.reshape(8, c), *args), got)
    assert t_k7_linear.launches == n


@pytest.mark.parametrize("use_kernel", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_int8_apply_matches_jax(use_kernel, dtype):
    m, c, s = 16, 64, 32
    x = _normal(4, (2, m // 2, c))
    w_q, w_s = j_qcol(jnp.asarray(_normal(5, (c, s), 0.05)))
    jx = jnp.asarray(x, dtype=dtype)
    want = jops.int8_apply(jx, w_q, w_s, use_kernel=use_kernel, interpret=True,
                           block_m=16, block_k=64, block_n=32)
    with tops.capture_fallbacks() as fbs:
        got = tops.int8_apply(torch.from_numpy(x).to(getattr(torch, dtype)), _t(w_q),
                              _t(w_s), use_kernel=use_kernel)
    assert [f.reason for f in fbs] == ["platform" if use_kernel else "disabled"]
    assert got.shape == (2, m // 2, s) and got.dtype == getattr(torch, dtype)
    want = np.asarray(want.astype(jnp.float32))
    tol = 1e-5 if dtype == "float32" else 2 ** -8
    np.testing.assert_allclose(got.float().numpy(), want, atol=tol * np.abs(want).max(),
                               rtol=tol)


@pytest.mark.parametrize("use_kernel", [True, False])
@pytest.mark.parametrize("r", [24, 119])
def test_int8_lowrank_apply_matches_jax(use_kernel, r):
    m, c, s = 16, 64, 32
    x = _normal(6, (m, c))
    u_q, u_s = j_qcol(jnp.asarray(_normal(7, (c, r), c ** -0.5)))
    v_q, v_s = j_qcol(jnp.asarray(_normal(8, (r, s), r ** -0.5)))
    want = np.asarray(jops.int8_lowrank_apply(
        jnp.asarray(x), u_q, u_s, v_q, v_s, use_kernel=use_kernel, interpret=True,
        block_m=16, block_k=64, block_n=32))
    with tops.capture_fallbacks() as fbs:
        got = tops.int8_lowrank_apply(torch.from_numpy(x), *(_t(a) for a in
                                                             (u_q, u_s, v_q, v_s)),
                                      use_kernel=use_kernel)
    assert [f.reason for f in fbs] == ["platform" if use_kernel else "disabled"]
    np.testing.assert_allclose(got.numpy(), want, atol=K7_TOL * np.abs(want).max(),
                               rtol=K7_TOL)


@pytest.mark.parametrize("mode", ["native", "bf16"])
@pytest.mark.parametrize("group", ["dense", "factors"])
def test_linear_on_int8_groups_matches_jax(mode, group):
    c, r, s = 64, 16, 32
    x = _normal(9, (2, 4, c))
    if group == "dense":
        kq, ks = j_qcol(jnp.asarray(_normal(10, (c, s), c ** -0.5)))
        jp = {"kernel_q": kq, "kernel_scale": ks}
    else:
        uq, us = j_qcol(jnp.asarray(_normal(11, (c, r), c ** -0.5)))
        vq, vs = j_qcol(jnp.asarray(_normal(12, (r, s), r ** -0.5)))
        jp = {"u_q": uq, "u_scale": us, "v_q": vq, "v_scale": vs}
    jp["bias"] = jnp.asarray(_normal(13, (s,), 0.1))
    tp = {k: _t(v) for k, v in jp.items()}
    jpol = jops.KernelPolicy(use_pallas=True, interpret=True, block_m=8, block_k=64,
                             block_n=32, int8_decode=mode)
    want = np.asarray(jcommon.linear(jp, jnp.asarray(x), use_pallas=jpol))
    got = tcommon.linear(tp, torch.from_numpy(x),
                         policy=tops.KernelPolicy(use_kernel=True, int8_decode=mode))
    np.testing.assert_allclose(got.numpy(), want, atol=K7_TOL * np.abs(want).max(),
                               rtol=K7_TOL)
