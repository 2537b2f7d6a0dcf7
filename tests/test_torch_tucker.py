"""The port's Tucker-2 conv path against the JAX package on the same numpy
inputs: Eq.-5 / Eq.-6 ranks and ``optimize_rank_tucker``'s decisions over a
grid of (C, S, k, alpha), ``tucker2_decompose`` and its reconstruction
error, ``RankResolver.tucker_ranks``, ``Decomposer.conv`` (layouts, plan
and the fan-in rule of 4-D kernels) and ``apply_lrd`` on a conv tree
(plan, layouts, each triple's reconstruction).

Eigenvectors are unique only up to sign, and torch's ``eigh`` and JAX's may
choose differently, so triples are compared through their reconstruction
``first . core . last``, which is sign-free.  The test weights have the
same known spectrum in both unfoldings, halving every 16 indices: an
eigenvector's float32 error grows as the Gram matrix's norm over its
eigengap at the truncation rank, and a random spectrum (with random
near-ties) would test that conditioning rather than the port.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import decompose as jdecompose
from repro.core import rank_opt as jrank_opt
from repro.core import tucker as jtucker
from repro.core.policy import NO_LRD as J_NO_LRD
from repro.core.policy import RESNET_DEFAULT as J_RESNET_DEFAULT
from repro_torch import bridge
from repro_torch.core import decompose, rank_opt, tucker
from repro_torch.core.policy import NO_LRD, RESNET_DEFAULT

torch.set_num_threads(1)

# reconstructions first . core . last: max |port - jax| / max |jax|, two
# float32 HOSVDs (Gram matrix, eigh, core contraction) of the same input
RECON_RTOL = 1e-4
# ||W - reconstruction||^2, relative to ||W||^2: the error is stationary in
# the eigenvectors, so it agrees to float32 rounding of the sums
ERR_RTOL = 1e-5

GRID = [(64, 64, 3, 2.0), (128, 128, 3, 2.0), (256, 256, 3, 2.0), (512, 512, 3, 2.0),
        (3, 64, 7, 2.0), (64, 128, 3, 1.5), (96, 200, 5, 3.0), (512, 512, 3, 4.0),
        (2048, 512, 3, 2.0)]


def _conv_weights(c, s, k, seed):
    """float32 ``(C, S, k, k)`` = sum_i d_i q1_i (x) q2_i (x) K_i, with
    orthonormal q1_i, q2_i, unit-norm k x k K_i and d_i = 2**(-i/16): both
    unfoldings' Gram matrices have the eigenvalues d_i^2."""
    rng = np.random.default_rng(seed)
    n = min(c, s)
    q1, _ = np.linalg.qr(rng.standard_normal((c, n)))
    q2, _ = np.linalg.qr(rng.standard_normal((s, n)))
    kk = rng.standard_normal((n, k, k))
    kk /= np.linalg.norm(kk, axis=(1, 2), keepdims=True)
    d = 2.0 ** (-np.arange(n) / 16)
    return np.einsum("ci,si,ikl->cskl", q1 * d, q2, kk).astype(np.float32)


def _recon(first, core_kk_last, last):
    """(C, S, k, k) reconstruction from a (C, r1), (r1, r2, k, k), (r2, S) triple."""
    return np.einsum("cp,pqkl,qs->cskl", *(np.asarray(a, np.float64)
                                             for a in (first, core_kk_last, last)),
                     optimize=True)


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / np.abs(want).max()


@pytest.mark.parametrize("c,s,k,alpha", GRID)
def test_tucker_ranks_and_algorithm1_match_jax(c, s, k, alpha):
    assert tucker.tucker_rank_for_compression(c, s, k, alpha) == \
        jtucker.tucker_rank_for_compression(c, s, k, alpha)
    assert tucker.tucker_rank_for_compression(c, s, k, alpha, beta=0.5) == \
        jtucker.tucker_rank_for_compression(c, s, k, alpha, beta=0.5)
    assert tucker.tucker_min_rank(c, s, k, alpha) == jtucker.tucker_min_rank(c, s, k, alpha)
    r1, r2 = tucker.tucker_rank_for_compression(c, s, k, alpha)
    assert tucker.tucker_compression_ratio(c, s, k, r1, r2) == \
        jtucker.tucker_compression_ratio(c, s, k, r1, r2)
    # stride 1 and the resolver's stride (mxu_tile // 4 = 32, then a refine)
    for stride in (1, 32):
        for m in (4096, 256):
            got = rank_opt.optimize_rank_tucker(c, s, k, alpha=alpha, m=m, stride=stride)
            want = jrank_opt.optimize_rank_tucker(c, s, k, alpha=alpha, m=m, stride=stride)
            assert (got.rank, got.use_decomposed, tuple(got.searched)) == \
                (want.rank, want.use_decomposed, tuple(want.searched))
            assert (got.original_time, got.decomposed_time, tuple(got.times)) == \
                (want.original_time, want.decomposed_time, tuple(want.times))
    with pytest.raises(ValueError, match="positive"):
        tucker.tucker_rank_for_compression(c, s, k, 0.0)


@pytest.mark.parametrize("c,s,k,r1,r2", [(16, 24, 3, 6, 9), (64, 64, 3, 38, 38),
                                         (32, 48, 5, 10, 48), (24, 16, 1, 7, 5)])
def test_tucker2_decompose_matches_jax(c, s, k, r1, r2):
    w = _conv_weights(c, s, k, seed=c + s + k)
    jf, jc, jl = jtucker.tucker2_decompose(jnp.asarray(w), r1, r2)
    tf, tc, tl = tucker.tucker2_decompose(torch.from_numpy(w), r1, r2)
    assert [tuple(t.shape) for t in (tf, tc, tl)] == [a.shape for a in (jf, jc, jl)]
    assert all(t.dtype == torch.float32 and t.is_contiguous() for t in (tf, tc, tl))
    assert _rel(_recon(tf, tc, tl), _recon(jf, jc, jl)) <= RECON_RTOL
    norm = float(np.sum(w.astype(np.float64) ** 2))
    t_err = float(tucker.tucker_reconstruction_error(torch.from_numpy(w), tf, tc, tl))
    j_err = float(jtucker.tucker_reconstruction_error(jnp.asarray(w), jf, jc, jl))
    assert abs(t_err - j_err) / norm <= ERR_RTOL
    # the port's error on JAX's own triple is JAX's error
    jt = bridge.from_numpy((w, jf, jc, jl))
    assert abs(float(tucker.tucker_reconstruction_error(*jt)) - j_err) / norm <= ERR_RTOL
    # the factors are orthonormal columns / rows, whatever their signs
    np.testing.assert_allclose(tf.T @ tf, np.eye(r1), atol=1e-5)
    # bf16 in, bf16 out (the HOSVD in float32)
    assert all(t.dtype == torch.bfloat16
               for t in tucker.tucker2_decompose(torch.from_numpy(w).bfloat16(), r1, r2))
    with pytest.raises(ValueError, match=r"\(C,S,k,k\)"):
        tucker.tucker2_decompose(torch.zeros(4, 4, 3), 2, 2)


POLICIES = {
    "eq5": (RESNET_DEFAULT.with_quantize(False), J_RESNET_DEFAULT.with_quantize(False)),
    "alg1": (RESNET_DEFAULT, J_RESNET_DEFAULT),
}


def _conv_tree():
    """HWIO kernels: a 7x7 stem (policy: dense), 3x3 convs of several
    geometries (one the Algorithm-1 guard keeps dense: 64 -> 160), a 5x5,
    1x1 convs (the guard keeps 64 -> 96 dense, not 256 -> 128), one under
    min_dim (48 -> 64 for the Tucker rule), and an fc."""
    def hwio(c, s, k, seed):
        return np.transpose(_conv_weights(c, s, k, seed), (2, 3, 0, 1)).copy()

    return {
        "conv_stem": {"kernel": hwio(3, 64, 7, 1), "scale": np.ones(64, np.float32)},
        "s0b0": {"conv3x3": {"kernel": hwio(64, 64, 3, 2)},
                 "conv1x1_a": {"kernel": hwio(64, 96, 1, 3)},
                 "shortcut": {"kernel": hwio(96, 48, 1, 4)}},
        "s1b0": {"conv3x3": {"kernel": hwio(96, 128, 3, 5)},
                 "conv5x5": {"kernel": hwio(72, 80, 5, 6)},
                 "conv3x3_small": {"kernel": hwio(48, 64, 3, 7)},
                 "conv1x1_b": {"kernel": hwio(256, 128, 1, 10)}},
        "s2b0": {"conv3x3": {"kernel": hwio(64, 160, 3, 8)}},
        "fc": {"kernel": _conv_weights(128, 10, 1, 9)[:, :, 0, 0].copy(),
               "bias": np.zeros(10, np.float32)},
    }


def _at(tree, path):
    for k in path.split("/"):
        tree = tree[k]
    return tree


@pytest.mark.parametrize("policy", sorted(POLICIES))
def test_apply_lrd_conv_tree_matches_jax(policy):
    tpol, jpol = POLICIES[policy]
    tree = _conv_tree()
    jtree, jplan = jdecompose.apply_lrd(jax.tree_util.tree_map(jnp.asarray, tree), jpol)
    ttree, tplan = decompose.apply_lrd(bridge.from_numpy(tree), tpol)
    assert json.loads(tplan.to_json()) == json.loads(jplan.to_json())
    assert tplan.summary() == jplan.summary()
    methods = {lp.method for lp in tplan.layers.values() if lp.use_decomposed}
    assert methods == {"svd", "tucker"}
    assert any(not lp.use_decomposed for lp in tplan.layers.values()) == (policy != "eq5")
    # the same leaves, shapes and untouched leaves everywhere
    shapes = jax.tree_util.tree_map(lambda a: tuple(a.shape), jtree)
    assert jax.tree_util.tree_map(lambda t: tuple(t.shape), ttree) == shapes
    assert ttree["conv_stem"]["kernel"] is not None and "first" not in ttree["conv_stem"]
    for path, lp in tplan.layers.items():
        tg, jg = _at(ttree, path), _at(jtree, path)
        if not lp.use_decomposed:
            assert set(tg) == {"kernel"}
        elif lp.method == "tucker":
            # HWIO core -> (r1, r2, k, k) for the reconstruction
            rec = [(g["first"], np.transpose(np.asarray(g["core"]), (2, 3, 0, 1)), g["last"])
                   for g in (tg, jg)]
            assert _rel(_recon(*rec[0]), _recon(*rec[1])) <= RECON_RTOL, path
            assert lp.rank2 == lp.rank  # apply_lrd's r2 rule (no cap at S)
        else:
            assert _rel(tg["u"] @ tg["v"], np.asarray(jg["u"]) @ np.asarray(jg["v"])) \
                <= RECON_RTOL, path


@pytest.mark.parametrize("policy", sorted(POLICIES))
def test_resolver_tucker_ranks_match_jax(policy):
    tpol, jpol = POLICIES[policy]
    tres, jres = decompose.RankResolver(), jdecompose.RankResolver()
    rule, jrule = tpol.rules[-1], jpol.rules[-1]
    for c, s, k, _ in GRID:
        got, want = tres.tucker_ranks(c, s, k, rule), jres.tucker_ranks(c, s, k, jrule)
        assert (got.rank, got.use_decomposed, got.original_time, got.decomposed_time) == \
            (want.rank, want.use_decomposed, want.original_time, want.decomposed_time)
        assert tres.tucker_ranks(c, s, k, rule) is got  # cached per geometry


# (path, C, S, k): a dense stem, Tucker 3x3s (r2 = min(r1, S) caps one), a
# 1x1 under a Tucker rule (-> SVD), a shortcut, one under min_dim, a 3x3
# the Algorithm-1 guard keeps dense (64 -> 160) and a 5x5
CONVS = [("conv_stem", 3, 64, 7), ("stage0/block0/conv3x3", 64, 64, 3),
         ("stage1/block0/conv3x3", 1024, 64, 3), ("stage0/block0/conv1x1_a", 256, 64, 1),
         ("stage0/block0/shortcut", 64, 256, 1), ("stage0/block0/convx", 32, 64, 3),
         ("stage3/block0/conv3x3", 64, 160, 3), ("stage1/block0/conv5x5", 72, 80, 5)]


@pytest.mark.parametrize("policy", sorted(POLICIES))
def test_decomposer_conv_matches_jax(policy):
    tpol, jpol = POLICIES[policy]
    tdec = decompose.Decomposer(tpol, dtype=torch.float32,
                                generator=torch.Generator().manual_seed(0))
    jdec = jdecompose.Decomposer(jpol, dtype=jnp.float32)
    for i, (path, c, s, k) in enumerate(CONVS):
        for stack in ((), (2,)):
            tp = tdec.conv(path, c, s, k, stack=stack)
            jp = jax.eval_shape(lambda key: jdec.conv(key, path, c, s, k, stack=stack),
                                jax.random.PRNGKey(i))
            assert {n: tuple(t.shape) for n, t in tp.items()} == \
                {n: a.shape for n, a in jp.items()}, (path, stack)
            assert all(t.dtype == torch.float32 for t in tp.values())
    assert json.loads(tdec.plan.to_json()) == json.loads(jdec.plan.to_json())
    assert {lp.method for lp in tdec.plan.layers.values()} == {"svd", "tucker"}
    if policy != "eq5":
        assert not tdec.plan.layers["stage3/block0/conv3x3"].use_decomposed
    capped = tdec.plan.layers["stage1/block0/conv3x3"]
    assert capped.rank > 64 and capped.rank2 == 64


@pytest.mark.parametrize("shape", [(7, 7, 3, 64), (3, 3, 64, 64), (1, 1, 256, 64),
                                   (2, 3, 3, 16, 32), (64, 96), (3, 40, 24)])
def test_dense_init_scale_matches_jax(shape):
    """The fan-in rule of ``_init_dense``: C of a matrix, kh * kw * C of an
    HWIO kernel, the three axes before S of a stacked one."""
    key = jax.random.PRNGKey(3)
    j_scale = np.asarray(jdecompose._init_dense(key, shape, jnp.float32)) / np.asarray(
        jax.random.normal(key, shape, jnp.float32))
    dec = decompose.Decomposer(NO_LRD, dtype=torch.float32,
                               generator=torch.Generator().manual_seed(1))
    ref = decompose.Decomposer(NO_LRD, dtype=torch.float32,
                               generator=torch.Generator().manual_seed(1))
    t_scale = (dec.dense(shape) / ref.normal(shape)).numpy()
    np.testing.assert_allclose(t_scale, np.median(j_scale), rtol=1e-6)
    np.testing.assert_allclose(j_scale, np.median(j_scale), rtol=1e-6)
    fan_in = np.prod(shape[-4:-1]) if len(shape) >= 4 else shape[-2]
    np.testing.assert_allclose(np.median(j_scale), 1.0 / np.sqrt(fan_in), rtol=1e-6)


def test_decomposer_conv_without_policy_is_dense():
    dec = decompose.Decomposer(None, dtype=torch.float32)
    jdec = jdecompose.Decomposer(None, dtype=jnp.float32)
    tp = dec.conv("stage0/block0/conv3x3", 64, 64, 3)
    jp = jax.eval_shape(lambda key: jdec.conv(key, "stage0/block0/conv3x3", 64, 64, 3),
                        jax.random.PRNGKey(0))
    assert set(tp) == set(jp) == {"kernel"} and not dec.plan.layers
    assert json.loads(dec.plan.to_json()) == json.loads(jdec.plan.to_json())
    assert jdecompose.Decomposer(J_NO_LRD).plan.policy_name == \
        decompose.Decomposer(NO_LRD).plan.policy_name
