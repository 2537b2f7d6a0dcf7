"""The port's kernel plain versions against the JAX Pallas kernels (interpret
mode, as tests/test_kernels.py runs them) and the JAX oracles, on the same
numpy inputs, and the CPU dispatch contract.  The CUDA kernels against
their plain versions on a GPU: tests/test_torch_kernels_gpu.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.lowrank_ffn import lowrank_gated_ffn as pallas_gated_ffn
from repro.kernels.lowrank_matmul import lowrank_matmul as pallas_lowrank_matmul
from repro_torch.kernels import ops, ref
from repro_torch.kernels.lowrank_ffn import lowrank_gated_ffn
from repro_torch.kernels.lowrank_matmul import lowrank_matmul

torch.set_num_threads(1)

TOL = 1e-5  # float32: the same products, summed in another order


def _mats(seed, *shapes):
    rng = np.random.default_rng(seed)
    out = [rng.standard_normal(shapes[0]).astype(np.float32)]
    for shape in shapes[1:]:
        out.append((rng.standard_normal(shape) / np.sqrt(shape[0])).astype(np.float32))
    return out


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got, np.float32), np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


# (m, c, r, s, bm, bk, bn): block-divisible for the Pallas kernels
MATMUL_SHAPES = [(64, 128, 32, 64, 32, 64, 32), (32, 256, 48, 128, 32, 128, 64)]


@pytest.mark.parametrize("m,c,r,s,bm,bk,bn", MATMUL_SHAPES)
def test_lowrank_matmul_ref_matches_pallas_and_jax_oracle(m, c, r, s, bm, bk, bn):
    x, u, v = _mats(m + c + r + s, (m, c), (c, r), (r, s))
    got = ref.lowrank_matmul_ref(*(torch.from_numpy(a) for a in (x, u, v)))
    pallas = pallas_lowrank_matmul(jnp.asarray(x), jnp.asarray(u), jnp.asarray(v),
                                   block_m=bm, block_k=bk, block_n=bn, interpret=True)
    _close(got.numpy(), pallas)
    _close(got.numpy(), jref.lowrank_matmul_ref(jnp.asarray(x), jnp.asarray(u),
                                                jnp.asarray(v)))


@pytest.mark.parametrize("m,c,r,f,bm,bk,bn", [(32, 128, 16, 64, 32, 64, 32),
                                              (64, 64, 24, 128, 32, 64, 64)])
def test_lowrank_gated_ffn_ref_matches_pallas_and_jax_oracle(m, c, r, f, bm, bk, bn):
    x, gu, gv, uu, uv = _mats(m + c + r + f, (m, c), (c, r), (r, f), (c, r), (r, f))
    got = ref.lowrank_gated_ffn_ref(*(torch.from_numpy(a) for a in (x, gu, gv, uu, uv)))
    jargs = [jnp.asarray(a) for a in (x, gu, gv, uu, uv)]
    pallas = pallas_gated_ffn(*jargs, block_m=bm, block_k=bk, block_n=bn, interpret=True)
    _close(got.numpy(), pallas)
    _close(got.numpy(), jref.lowrank_gated_ffn_ref(*jargs))


def test_cpu_dispatch_takes_plain_version_and_launches_nothing():
    """On CPU tensors the wrappers and the dispatcher run the plain version
    (recorded as a ``platform`` fallback, or ``disabled`` with the policy
    off) and no kernel launch is counted."""
    x, u, v = (torch.from_numpy(a) for a in _mats(1, (2, 5, 40), (40, 8), (8, 24)))
    _, gu, gv = (torch.from_numpy(a) for a in _mats(2, (1,), (40, 8), (8, 24)))
    k1, k5 = lowrank_matmul.launches, lowrank_gated_ffn.launches
    shapes = dict(lowrank_matmul.launches_by_shape), dict(lowrank_gated_ffn.launches_by_shape)
    with ops.capture_fallbacks() as fbs:
        y = ops.lowrank_apply(x, u, v, use_kernel=True)
        h = ops.lowrank_ffn_apply(x, gu, gv, u, v, use_kernel=True)
        ops.lowrank_apply(x, u, v, use_kernel=False)
    assert y.shape == (2, 5, 24) and h.shape == (2, 5, 24)
    _close(y.numpy(), ref.lowrank_matmul_ref(x.reshape(10, 40), u, v).reshape(2, 5, 24).numpy())
    assert [(f.op, f.reason, f.shape) for f in fbs] == [
        ("lowrank_fwd", "platform", (10, 40, 24)),
        ("lowrank_ffn", "platform", (10, 40, 24)),
        ("lowrank_fwd", "disabled", (10, 40, 24))]
    _close(lowrank_matmul(x[0], u, v).numpy(), ref.lowrank_matmul_ref(x[0], u, v).numpy())
    _close(lowrank_gated_ffn(x[0], gu, gv, u, v).numpy(),
           ref.lowrank_gated_ffn_ref(x[0], gu, gv, u, v).numpy())
    assert (lowrank_matmul.launches, lowrank_gated_ffn.launches) == (k1, k5)
    assert (lowrank_matmul.launches_by_shape, lowrank_gated_ffn.launches_by_shape) == shapes


def test_policy_normalisation():
    assert ops.as_policy(True) == ops.KernelPolicy(use_kernel=True)
    assert not ops.as_policy(None)
    pol = ops.KernelPolicy(use_kernel=True)
    assert ops.as_policy(pol) is pol
