"""Decomposition of dense weights in the port against the JAX package, on
the same numpy inputs: ``svd.svd_decompose`` (2-D and stacked, three
balances), ``svd.randomized_svd`` with JAX's sketch matrix put in the
port's place, ``svd.reconstruction_error``, ``decompose.apply_lrd`` on the
smoke LM's dense tree from JAX's init (Eq.-5 and Algorithm-1 ranks, and a
wider model where Algorithm 1 keeps layers factorised), its 1x1-conv
and randomized branches and the k x k conv's Tucker branch, and
``freezing.apply_freeze`` / ``trainable_fraction`` / ``factor_rank_axis``.

Singular vectors are unique up to sign, and the two packages' LAPACK calls
do flip whole columns on some shapes here, so factors are compared after
aligning each column's sign (``u[:, j]`` and ``v[j, :]`` flip together);
products need no alignment.  The test weights have a spectrum that halves
every four singular values: a singular vector's float32 error grows as
sigma_1 over the gap at the truncation rank, and a flat random spectrum
would test that conditioning rather than the port.  ``randomized_svd``'s
two power iterations raise the spectrum to the fifth power without
re-orthogonalising, so in float32 a wide spectrum loses the sketch's
trailing directions to rounding in both packages alike; its weights halve
every 64 singular values and halve once more past the truncation rank.
"""

import dataclasses
import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config
from repro.configs.base import DistConfig, LRDConfig, RunConfig, ShapeConfig
from repro.core import decompose as jdecompose
from repro.core import freezing as jfreezing
from repro.core import svd as jsvd
from repro.core.policy import LM_DEFAULT as J_LM_DEFAULT
from repro.core.policy import RESNET_DEFAULT as J_RESNET_DEFAULT
from repro.launch import steps as jsteps
from repro_torch import bridge
from repro_torch.configs import get_smoke_config as t_smoke
from repro_torch.configs.base import LRDConfig as TLRDConfig
from repro_torch.configs.base import RunConfig as TRunConfig
from repro_torch.configs.base import ShapeConfig as TShapeConfig
from repro_torch.core import decompose, freezing, svd
from repro_torch.core.policy import LM_DEFAULT, RESNET_DEFAULT
from repro_torch.launch import steps

torch.set_num_threads(1)

# products: max |port - jax| / max |jax|, float32 SVDs of the same input
PRODUCT_RTOL = 1e-5
# factors after sign alignment, relative to the factor's max |jax|
FACTOR_RTOL = 1e-4
# apply_lrd's products per layer (stacked SVDs, float32)
LRD_RTOL = 1e-4


def _weights(shape, seed, halving=4, step_at=None):
    """float32 weights ``Q_1 diag(s) Q_2`` per matrix, s_i = 4 * 2**(-i/halving),
    halved once more from ``i = step_at``."""
    rng = np.random.default_rng(seed)
    *lead, c, s = shape
    n = min(c, s)
    i = np.arange(n)
    sigma = 4.0 * 2.0 ** (-i / halving) * np.where(i < (step_at or n), 1.0, 0.5)
    out = []
    for _ in range(int(np.prod(lead)) if lead else 1):
        q1, _ = np.linalg.qr(rng.standard_normal((c, n)))
        q2, _ = np.linalg.qr(rng.standard_normal((s, n)))
        out.append((q1 * sigma) @ q2.T)
    return np.stack(out).reshape(shape).astype(np.float32)


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / np.abs(want).max()


def _same_factors(tu, tv, ju, jv):
    """Port factors against JAX's up to a sign per rank column."""
    tu, tv, ju, jv = (np.asarray(a, np.float64) for a in (tu, tv, ju, jv))
    sign = np.sign(np.sum(tu * ju, axis=-2))  # (..., r)
    assert _rel(tu * sign[..., None, :], ju) <= FACTOR_RTOL
    assert _rel(tv * sign[..., :, None], jv) <= FACTOR_RTOL
    assert _rel(tu @ tv, ju @ jv) <= PRODUCT_RTOL


@pytest.mark.parametrize("balance", ["balanced", "left", "right"])
@pytest.mark.parametrize("shape,rank", [((48, 32), 12), ((64, 96), 20), ((3, 40, 24), 9),
                                        ((2, 128, 64), 21)])
def test_svd_decompose_matches_jax(shape, rank, balance):
    w = _weights(shape, seed=sum(shape) + rank)
    ju, jv = jsvd.svd_decompose(jnp.asarray(w), rank, balance=balance)
    tu, tv = svd.svd_decompose(torch.from_numpy(w), rank, balance=balance)
    assert tuple(tu.shape) == ju.shape and tuple(tv.shape) == jv.shape
    assert tu.dtype == tv.dtype == torch.float32
    assert tu.is_contiguous() and tv.is_contiguous()  # the kernels' operand layout
    _same_factors(tu.numpy(), tv.numpy(), ju, jv)
    # bf16 in, bf16 out (the SVD in float32)
    bu, bv = svd.svd_decompose(torch.from_numpy(w).bfloat16(), rank, balance=balance)
    assert bu.dtype == bv.dtype == torch.bfloat16
    with pytest.raises(ValueError, match="2-D or 3-D"):
        svd.svd_decompose(torch.zeros(2, 2, 4, 4), 2)


def _jax_sketch(s, k, seed, device):
    return torch.from_numpy(np.array(jax.random.normal(jax.random.PRNGKey(seed), (s, k),
                                                       jnp.float32))).to(device)


@pytest.mark.parametrize("balance", ["balanced", "left", "right"])
@pytest.mark.parametrize("c,s,rank,seed", [(64, 48, 8, 0), (96, 200, 20, 3), (256, 640, 64, 1)])
def test_randomized_svd_matches_jax_on_jax_sketch(monkeypatch, c, s, rank, seed, balance):
    w = _weights((c, s), seed=c + s, halving=64, step_at=rank)
    ju, jv = jsvd.randomized_svd(jnp.asarray(w), rank, seed=seed, balance=balance)
    monkeypatch.setattr(svd, "_sketch", _jax_sketch)
    tu, tv = svd.randomized_svd(torch.from_numpy(w), rank, seed=seed, balance=balance)
    assert tu.is_contiguous() and tv.is_contiguous()
    _same_factors(tu.numpy(), tv.numpy(), ju, jv)


def test_sketch_is_drawn_on_the_cpu_from_its_seed():
    a = svd._sketch(40, 12, 5, "cpu")
    assert a.shape == (40, 12) and a.dtype == torch.float32
    assert torch.equal(a, svd._sketch(40, 12, 5, torch.device("cpu")))
    assert not torch.equal(a, svd._sketch(40, 12, 6, "cpu"))


def test_reconstruction_error_matches_jax():
    rng = np.random.default_rng(7)
    w = rng.standard_normal((40, 24)).astype(np.float32)
    u = rng.standard_normal((40, 6)).astype(np.float32)
    v = rng.standard_normal((6, 24)).astype(np.float32)
    got = svd.reconstruction_error(*(torch.from_numpy(a) for a in (w, u, v))).item()
    want = float(jsvd.reconstruction_error(*(jnp.asarray(a) for a in (w, u, v))))
    assert abs(got - want) <= PRODUCT_RTOL * want
    # the truncated SVD's error is the tail of the spectrum (Eq. 3)
    w = _weights((48, 32), seed=1)
    tu, tv = svd.svd_decompose(torch.from_numpy(w), 10)
    tail = np.linalg.svd(w.astype(np.float64), compute_uv=False)[10:]
    np.testing.assert_allclose(svd.reconstruction_error(torch.from_numpy(w), tu, tv).item(),
                               np.sum(tail ** 2), rtol=1e-4)


# --------------------------------------------------------------------------
# apply_lrd on the smoke LM's dense tree (JAX's init, carried over)
# --------------------------------------------------------------------------

WIDE = dict(d_model=256, d_ff=640, head_dim=64)  # Algorithm 1 quantizes some ranks


@functools.lru_cache(maxsize=None)
def _dense(wide: bool):
    over = WIDE if wide else {}
    run = RunConfig(model=dataclasses.replace(get_smoke_config("smollm-360m"), **over),
                    shape=ShapeConfig("t", 8, 2, "train"), lrd=LRDConfig(enabled=False),
                    dist=DistConfig(fsdp=False, remat="none"))
    params, plan = jsteps.init_params(run, jax.random.PRNGKey(0))
    assert not plan.layers
    return jax.tree_util.tree_map(np.asarray, params)


def _flat(tree, path=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{path}/{k}" if path else k))
        return out
    return {path: np.asarray(tree.numpy() if isinstance(tree, torch.Tensor) else tree)}


def _plan(plan):
    return {p: dataclasses.asdict(lp) for p, lp in plan.layers.items()}


@pytest.mark.parametrize("quantize", [False, True], ids=["eq5", "alg1"])
@pytest.mark.parametrize("wide", [False, True], ids=["smoke", "wide"])
def test_apply_lrd_matches_jax_and_the_init_plan(wide, quantize):
    dense = _dense(wide)
    jpol = J_LM_DEFAULT.with_quantize(quantize).with_min_dim(16)
    tpol = LM_DEFAULT.with_quantize(quantize).with_min_dim(16)
    jtree, jplan = jdecompose.apply_lrd(jax.tree_util.tree_map(jnp.asarray, dense), jpol)
    ttree, tplan = decompose.apply_lrd(bridge.from_numpy(dense), tpol)
    assert json.loads(tplan.to_json()) == json.loads(jplan.to_json()) and len(tplan.layers) == 7
    assert tplan.policy_name == jplan.policy_name
    kept = {p for p, lp in tplan.layers.items() if lp.use_decomposed}
    assert kept == {p for p, _ in decompose.iter_factor_groups(ttree)}
    assert quantize or len(kept) == 7
    if wide and quantize:  # Algorithm 1 moves some ranks off Eq. 5
        assert kept and any(lp.rank != lp.eq5_rank for lp in tplan.layers.values())
    jflat, tflat = _flat(jtree), _flat(ttree)
    assert sorted(tflat) == sorted(jflat)
    jgroups = dict(jdecompose.iter_factor_groups(jtree))
    for path, g in decompose.iter_factor_groups(ttree):
        want = np.asarray(jgroups[path]["u"]) @ np.asarray(jgroups[path]["v"])
        assert _rel((g["u"] @ g["v"]).numpy(), want) <= LRD_RTOL, path
    for key, a in tflat.items():  # every other leaf passes through as is
        if not key.endswith(("/u", "/v")):
            np.testing.assert_array_equal(a, jflat[key], err_msg=key)
    # the plan Decomposer.linear records at init for the same policy and ranks;
    # the init names the stacked layers "layers", the tree keeps them under "stack"
    over = WIDE if wide else {}
    trun = TRunConfig(model=dataclasses.replace(t_smoke("smollm-360m"), **over),
                      shape=TShapeConfig("t", 8, 2, "train"),
                      lrd=TLRDConfig(enabled=True, min_dim=16, rank_quantize=quantize))
    _, init_plan = steps.init_params(trun, device="cpu")
    renamed = {p.replace("layers/", "stack/", 1): dict(d, path=p.replace("layers/", "stack/", 1))
               for p, d in _plan(init_plan).items()}
    assert _plan(tplan) == renamed


def test_apply_lrd_takes_randomized_svd_above_its_threshold(monkeypatch):
    rng = np.random.default_rng(3)
    # Eq. 5 gives the 2-D head rank 160 * 96 / (2 * 256) = 30
    tree = {"head": {"kernel": _weights((160, 96), seed=4, halving=64, step_at=30),
                     "bias": rng.standard_normal(96).astype(np.float32)},
            "block": {"wo": {"kernel": _weights((2, 96, 96), seed=5)}}}
    pol = LM_DEFAULT.with_quantize(False).with_min_dim(16)
    jtree, jplan = jdecompose.apply_lrd(jax.tree_util.tree_map(jnp.asarray, tree),
                                        J_LM_DEFAULT.with_quantize(False).with_min_dim(16),
                                        use_randomized_svd_above=10_000)
    monkeypatch.setattr(svd, "_sketch", _jax_sketch)
    calls = []
    real = svd.randomized_svd
    monkeypatch.setattr(svd, "randomized_svd", lambda *a, **k: calls.append(a[1]) or real(*a, **k))
    ttree, tplan = decompose.apply_lrd(bridge.from_numpy(tree), pol,
                                       use_randomized_svd_above=10_000)
    assert json.loads(tplan.to_json()) == json.loads(jplan.to_json())
    assert calls == [tplan.layers["head"].rank]  # 2-D above the threshold only
    for path in ("head", "block/wo"):
        g = dict(decompose.iter_factor_groups(ttree))[path]
        jg = dict(jdecompose.iter_factor_groups(jtree))[path]
        assert _rel((g["u"] @ g["v"]).numpy(), np.asarray(jg["u"]) @ np.asarray(jg["v"])) \
            <= PRODUCT_RTOL
    np.testing.assert_array_equal(ttree["head"]["bias"].numpy(), tree["head"]["bias"])


def test_apply_lrd_conv_kernels():
    """A 1x1 HWIO conv kernel is a matrix and takes the SVD, as in JAX; a
    k x k kernel under a Tucker rule takes the Tucker-2 triple, as in JAX
    (``test_torch_tucker.py`` holds its reconstruction)."""
    tree = {"conv_a_1x1": {"kernel": _weights((64, 96), seed=6)[None, None]},
            "fc": {"kernel": _weights((64, 80), seed=7)}}
    jtree, jplan = jdecompose.apply_lrd(jax.tree_util.tree_map(jnp.asarray, tree),
                                        J_RESNET_DEFAULT.with_quantize(False))
    ttree, tplan = decompose.apply_lrd(bridge.from_numpy(tree),
                                       RESNET_DEFAULT.with_quantize(False))
    assert json.loads(tplan.to_json()) == json.loads(jplan.to_json()) and set(tplan.layers) == {"conv_a_1x1", "fc"}
    g, jg = ttree["conv_a_1x1"], jtree["conv_a_1x1"]
    assert set(g) == {"u", "v"} and tuple(g["u"].shape) == jg["u"].shape
    assert _rel((g["u"] @ g["v"]).numpy(), np.asarray(jg["u"]) @ np.asarray(jg["v"])) \
        <= PRODUCT_RTOL
    conv = {"conv3": {"kernel": torch.from_numpy(
        np.random.default_rng(8).standard_normal((3, 3, 64, 64)).astype(np.float32))}}
    jout, jplan = jdecompose.apply_lrd({"conv3": {"kernel": jnp.asarray(
        conv["conv3"]["kernel"].numpy())}}, J_RESNET_DEFAULT)
    out, plan = decompose.apply_lrd(conv, RESNET_DEFAULT)
    assert json.loads(plan.to_json()) == json.loads(jplan.to_json())
    assert plan.layers["conv3"].method == "tucker"
    assert {k: tuple(v.shape) for k, v in out["conv3"].items()} == \
        {k: v.shape for k, v in jout["conv3"].items()}
    # under a rule that is not Tucker a k x k kernel stays dense, as in JAX
    out, plan = decompose.apply_lrd(conv, LM_DEFAULT.with_quantize(False))
    assert out["conv3"]["kernel"] is conv["conv3"]["kernel"] and not plan.layers


# --------------------------------------------------------------------------
# freezing helpers
# --------------------------------------------------------------------------

def _tree():
    rng = np.random.default_rng(2)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    return {"embed": {"embedding": f(8, 4)},
            "stack": {"attn": {"wq": {"u": f(2, 4, 3), "v": f(2, 3, 4), "bias": f(2, 4)}},
                      "ffn": {"down": {"kernel": f(2, 4, 4)}},
                      "tucker": {"first": f(3, 2), "core": f(2, 2), "last": f(2, 3)}}}


@pytest.mark.parametrize("phase", [-1, 0, 1])
def test_apply_freeze_and_trainable_fraction_match_jax(phase):
    tree = _tree()
    mask = freezing.freeze_mask(tree, phase)
    assert mask == jfreezing.freeze_mask(tree, phase)
    assert freezing.trainable_fraction(mask, bridge.from_numpy(tree)) == pytest.approx(
        jfreezing.trainable_fraction(mask, tree), rel=1e-12)
    leaves = bridge.from_numpy(tree)
    live = freezing.tree_map(lambda t: t.requires_grad_(True), leaves)
    frozen_view = freezing.apply_freeze(live, mask)
    loss = sum(t.sum() for t in freezing.tree_leaves(frozen_view))
    loss.backward()
    for (path, t), m in zip(_flat_tensors(live), freezing.tree_leaves(mask)):
        assert (t.grad is not None) == m, path
    for a, b in zip(freezing.tree_leaves(frozen_view), freezing.tree_leaves(live)):
        assert a.data_ptr() == b.data_ptr()  # no copies


def _flat_tensors(tree, path=""):
    if isinstance(tree, dict):
        return [kv for k, v in tree.items() for kv in _flat_tensors(v, f"{path}/{k}")]
    return [(path, tree)]


def test_factor_rank_axis_matches_jax():
    for name in ("u", "v", "bias", "kernel", "first", "core", "last", "scale"):
        assert freezing.factor_rank_axis(name) == jfreezing.factor_rank_axis(name)
    assert freezing.factor_rank_axis("u") == -1 and freezing.factor_rank_axis("v") == -2
