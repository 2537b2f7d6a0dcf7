"""The port's backward against the JAX package on the same numpy inputs:
the K2-K4 plain versions against the Pallas kernels (interpret mode) and
JAX autodiff of the oracle; ``lowrank_apply`` / ``lowrank_ffn_apply``
gradients against the JAX freezing-aware custom VJPs for every
``freeze_group``; and the dispatch record, which shows the frozen factor's
gradient never computed.  float32 throughout."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import lowrank_bwd as jbwd
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import ops, ref

torch.set_num_threads(1)

# float32: the same products summed in another order; dU/dV sum over M
TOL = 1e-5
BLOCKS = dict(block_m=32, block_k=64, block_n=32)  # divide every shape below


def _mats(seed, *shapes):
    rng = np.random.default_rng(seed)
    out = [rng.standard_normal(shapes[0]).astype(np.float32)]
    for shape in shapes[1:]:
        out.append((rng.standard_normal(shape) / np.sqrt(shape[0])).astype(np.float32))
    return out


def _close(got, want, tol=TOL):
    got = np.zeros_like(np.asarray(want, np.float32)) if got is None else got
    np.testing.assert_allclose(np.asarray(got, np.float32), np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


def _t(a, grad=False):
    return torch.from_numpy(np.array(a)).requires_grad_(grad)


# (m, c, r, s): block-divisible for the Pallas kernels
SHAPES = [(64, 128, 32, 64), (32, 64, 24, 96)]


@pytest.mark.parametrize("m,c,r,s", SHAPES)
def test_bwd_plain_versions_match_pallas_and_jax_autodiff(m, c, r, s):
    x, dy, u, v = _mats(m + c + r + s, (m, c), (m, s), (c, r), (r, s))
    jx, jdy, ju, jv = (jnp.asarray(a) for a in (x, dy, u, v))
    _, vjp = jax.vjp(jref.lowrank_matmul_ref, jx, ju, jv)
    adx, adu, adv = vjp(jdy)
    pdx = jbwd.lowrank_matmul_dx(jdy, ju, jv, interpret=True, **BLOCKS)
    pdu = jbwd.lowrank_matmul_du(jx, jdy, jv, interpret=True, **BLOCKS)
    pdv = jbwd.lowrank_matmul_dv(jx, ju, jdy, interpret=True, **BLOCKS)
    tx, tdy, tu, tv = (_t(a) for a in (x, dy, u, v))
    dx = ref.lowrank_matmul_dx_ref(tdy, tu, tv).numpy()
    du = ref.lowrank_matmul_du_ref(tx, tdy, tv).numpy()
    dv = ref.lowrank_matmul_dv_ref(tx, tu, tdy).numpy()
    for got, pallas, auto in ((dx, pdx, adx), (du, pdu, adu), (dv, pdv, adv)):
        _close(got, pallas)
        _close(got, auto)


def _fallback_ops(fbs):
    counts = {}
    for f in fbs:
        counts[f.op] = counts.get(f.op, 0) + 1
    return counts


@pytest.mark.parametrize("g", [None, 0, 1])
def test_lowrank_apply_grads_match_jax_vjp(g):
    m, c, r, s = 64, 128, 32, 64
    x, dy, u, v = _mats(11, (2, m // 2, c), (2, m // 2, s), (c, r), (r, s))

    def jloss(x, u, v):
        y = jops.lowrank_apply(x, u, v, use_kernel=True, interpret=True, freeze_group=g,
                               **BLOCKS)
        return jnp.sum(y * dy), y

    (_, jy), jgrads = jax.value_and_grad(jloss, argnums=(0, 1, 2), has_aux=True)(
        *(jnp.asarray(a) for a in (x, u, v)))
    tx, tu, tv = (_t(a, grad=True) for a in (x, u, v))
    with ops.capture_fallbacks() as fbs:
        y = ops.lowrank_apply(tx, tu, tv, use_kernel=True, freeze_group=g)
        y.backward(_t(dy))
    _close(y.detach().numpy(), jy)
    for got, want in zip((tx.grad, tu.grad, tv.grad), jgrads):
        _close(None if got is None else got.numpy(), want)
    # the CPU decision record: one plain call per gradient computed, none
    # for the frozen factor
    assert _fallback_ops(fbs) == {"lowrank_fwd": 1, "lowrank_dx": 1,
                                  **({} if g == 0 else {"lowrank_du": 1}),
                                  **({} if g == 1 else {"lowrank_dv": 1})}
    assert {f.reason for f in fbs} == {"platform"}
    assert (tu.grad is None) == (g == 0) and (tv.grad is None) == (g == 1)


@pytest.mark.parametrize("g", [None, 0, 1])
def test_lowrank_ffn_apply_grads_match_jax_vjp(g):
    m, c, r, f = 64, 64, 16, 128
    x, dy, gu, gv, uu, uv = _mats(12, (m, c), (m, f), (c, r), (r, f), (c, r), (r, f))

    def jloss(*args):
        y = jops.lowrank_ffn_apply(*args, use_kernel=True, interpret=True, freeze_group=g,
                                   **BLOCKS)
        return jnp.sum(y * dy), y

    (_, jy), jgrads = jax.value_and_grad(jloss, argnums=(0, 1, 2, 3, 4), has_aux=True)(
        *(jnp.asarray(a) for a in (x, gu, gv, uu, uv)))
    targs = [_t(a, grad=True) for a in (x, gu, gv, uu, uv)]
    with ops.capture_fallbacks() as fbs:
        y = ops.lowrank_ffn_apply(*targs, use_kernel=False, freeze_group=g)
        y.backward(_t(dy))
    _close(y.detach().numpy(), jy)
    for got, want in zip(targs, jgrads):
        _close(None if got.grad is None else got.grad.numpy(), want)
    assert _fallback_ops(fbs) == {"lowrank_ffn": 1, "lowrank_fwd": 2, "lowrank_dx": 2,
                                  **({} if g == 0 else {"lowrank_du": 2}),
                                  **({} if g == 1 else {"lowrank_dv": 2})}
    assert {f.reason for f in fbs} == {"disabled"}


def test_gradient_of_a_factor_autograd_does_not_ask_for_is_never_computed():
    """Without any freeze_group, a factor that does not require grad (a
    frozen leaf of the train step) gets no gradient computed either."""
    x, u, v = _mats(13, (8, 16), (16, 4), (4, 12))
    tx, tu, tv = _t(x, grad=True), _t(u), _t(v, grad=True)
    with ops.capture_fallbacks() as fbs:
        ops.lowrank_apply(tx, tu, tv).sum().backward()
    assert _fallback_ops(fbs) == {"lowrank_fwd": 1, "lowrank_dx": 1, "lowrank_dv": 1}
    assert tu.grad is None and tv.grad is not None


def test_kernel_operand_check_refuses_leaves_that_require_grad_under_grad_mode():
    """A kernel wrapper called directly on a leaf that requires grad would
    return a result with no grad_fn; the operand check raises first.  The
    autograd Functions call the wrappers with grad mode off, where the
    same leaf passes this check."""
    from repro_torch.kernels.lowrank_matmul import check_cuda_operands

    leaf = torch.zeros(4, 4, dtype=torch.bfloat16, requires_grad=True)
    with pytest.raises(ValueError, match="requires grad"):
        check_cuda_operands("lowrank_matmul", (leaf,))
    with torch.no_grad(), pytest.raises(Exception) as info:
        check_cuda_operands("lowrank_matmul", (leaf,))
    assert "requires grad" not in str(info.value)
