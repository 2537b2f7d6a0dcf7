"""The port's ResNet against the JAX package, on the same numpy inputs and
JAX-made parameters: ``conv_apply`` (dense kernels of 1, 3 and 7, the
Tucker triple and the SVD pair; strides 1 and 2; odd and even sizes, where
XLA's SAME padding is asymmetric), the max-pool, ``bottleneck_apply`` with
and without a shortcut, ``resnet_init``'s layout and plan, the bridge's
round trip of JAX's ResNet and ViT trees, ``apply_lrd``
on ResNet-50 (its plan and layout against JAX's, each layer's error
against a float64 decomposition), ``resnet_apply`` (ResNet-50 at 32 x 32,
batch 2, dense and decomposed), and the classification loss and gradients
of the paper's train step at phases -1, 0 and 1 for ResNet-50 and the ViT.
The decomposed ResNet-50 is JAX's init at Eq.-5 ranks (random factors):
JAX's own ``apply_lrd`` of ResNet-50 takes minutes under the suite's
parallel workers, and ``test_torch_tucker.py`` holds the port's
``apply_lrd`` to it on a conv tree.

All in float32 on the CPU; tolerances are max |port - jax| / max |jax|
unless stated.
"""

import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import freezing as jfreezing
from repro.core.decompose import Decomposer as JDecomposer
from repro.core.decompose import apply_lrd as j_apply_lrd
from repro.core.policy import NO_LRD as J_NO_LRD
from repro.core.policy import RESNET_DEFAULT as J_RESNET_DEFAULT
from repro.core.policy import DecompositionPolicy as JPolicy
from repro.core.policy import Rule as JRule
from repro.models import resnet as jresnet
from repro.models import vit as jvit
from repro_torch import bridge
from repro_torch.core import freezing, svd, tucker
from repro_torch.core.decompose import Decomposer, apply_lrd
from repro_torch.core.policy import RESNET_DEFAULT, DecompositionPolicy, Rule
from repro_torch.models import resnet, vit
from repro_torch.models.common import cross_entropy

torch.set_num_threads(1)

# one conv, max-pool or bottleneck: float32 sums of at most 7*7*6 terms in
# another order
OP_RTOL = 1e-5
# ResNet-50 logits: 53 convs of float32 rounding in another order (a CPU
# run gives 1.6e-6)
LOGITS_RTOL = 2e-5
# apply_lrd's ||W - reconstruction||^2 against a float64 SVD's / HOSVD's,
# relative to ||W||^2: the error is second order in the factors' float32
# rounding (random weights' near-ties at the cut move a float32
# reconstruction's entries by up to 6e-5 of max |W|, but not its error)
ERR_RTOL = 1e-5
# each leaf's gradient, relative to that leaf's max |jax grad|: the loss's
# backward through the same 53 layers, float32; plus an absolute floor for
# the ViT's key bias, whose gradient is zero in exact arithmetic (softmax is
# shift-invariant along a query's row), which leaves float32 noise of ~1e-9
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-7
LOSS_RTOL = 1e-6

# the benchmarks' method ladder at alpha 2 (benchmarks/common.py:18-27)
J_EQ5 = J_RESNET_DEFAULT.with_alpha(2.0).with_quantize(False).with_min_dim(32)
J_ALG1 = J_RESNET_DEFAULT.with_alpha(2.0).with_quantize(True).with_min_dim(32)
EQ5 = RESNET_DEFAULT.with_alpha(2.0).with_quantize(False).with_min_dim(32)
ALG1 = RESNET_DEFAULT.with_alpha(2.0).with_quantize(True).with_min_dim(32)
# the ViT policy of benchmarks/table4_vit.py:19-26
J_VIT = JPolicy(name="vit-ffn", rules=(
    JRule(r"(norm|bias|pos_emb|cls|head)", "none"),
    JRule(r"(wi|down|patch_embed)", "svd", min_dim=32), JRule(r".*", "none")))
VIT = DecompositionPolicy(name="vit-ffn", rules=(
    Rule(r"(norm|bias|pos_emb|cls|head)", "none"),
    Rule(r"(wi|down|patch_embed)", "svd", min_dim=32), Rule(r".*", "none")))
VIT_SHAPE = dict(num_layers=2, d=96, heads=3, d_ff=384, patch=8, img=32)


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / np.abs(want).max()


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _at(tree, path):
    for k in path.split("/"):
        tree = tree[k]
    return tree


def _leaves(tree, path=""):
    """(path, leaf) of a nested dict, in key order."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{path}/{k}" if path else k)
    else:
        yield path, tree


@pytest.fixture(scope="module")
def trees():
    """JAX-made ResNet-50 (10 classes), dense and at Eq.-5 ranks (JAX's init
    draws the factors), as numpy, and the Eq.-5 init's plan."""
    decs = [JDecomposer(policy, dtype=jnp.float32) for policy in (J_NO_LRD, J_EQ5)]
    dense, eq5 = jax.jit(lambda k: [jresnet.resnet_init(k, "resnet50", 10, dec)
                                    for dec in decs])(jax.random.PRNGKey(0))
    return _np(dense), _np(eq5), decs[1].plan


def _init_path(path):
    """The init's plan name of a tree path: ``s1b0/conv3x3`` ->
    ``stage1/block0/conv3x3``."""
    head, _, rest = path.partition("/")
    if head[0] == "s" and "b" in head and rest:
        si, bi = head[1:].split("b")
        return f"stage{si}/block{bi}/{rest}"
    return path


# --------------------------------------------------------------------------
# conv_apply, max-pool, bottleneck
# --------------------------------------------------------------------------

def _conv_params(branch, rng, c=6, s=10, r=4):
    def w(*shape):
        return (rng.standard_normal(shape) / np.sqrt(shape[-2])).astype(np.float32)

    p = {"dense1": lambda: {"kernel": w(1, 1, c, s)},
         "dense3": lambda: {"kernel": w(3, 3, c, s)},
         "dense7": lambda: {"kernel": w(7, 7, c, s)},
         "tucker": lambda: {"first": w(c, r), "core": w(3, 3, r, r + 1), "last": w(r + 1, s)},
         "svd": lambda: {"u": w(c, r), "v": w(r, s)}}[branch]()
    p["scale"] = rng.uniform(0.5, 1.5, s).astype(np.float32)
    p["bn_bias"] = rng.standard_normal(s).astype(np.float32)
    return p


BRANCHES = ["dense1", "dense3", "dense7", "tucker", "svd"]


@pytest.mark.parametrize("hw", [(7, 7), (8, 8), (7, 8), (2, 2)])
@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("branch", BRANCHES)
def test_conv_apply_matches_jax(branch, stride, hw):
    rng = np.random.default_rng([BRANCHES.index(branch), stride, *hw])
    p = _conv_params(branch, rng)
    x = rng.standard_normal((2, *hw, 6)).astype(np.float32)
    want = np.asarray(jresnet.conv_apply(jax.tree_util.tree_map(jnp.asarray, p),
                                         jnp.asarray(x), stride))
    got = resnet.conv_apply(bridge.from_numpy(p), torch.from_numpy(x), stride)
    assert tuple(got.shape) == want.shape and got.dtype == torch.float32
    assert _rel(got, want) <= OP_RTOL


@pytest.mark.parametrize("n,k,stride,pads", [(224, 7, 2, (2, 3)), (56, 3, 2, (0, 1)),
                                             (7, 3, 2, (1, 1)), (56, 1, 2, (0, 0)),
                                             (56, 3, 1, (1, 1)), (112, 3, 2, (0, 1))])
def test_same_pads_are_xla_s(n, k, stride, pads):
    """XLA's padding at the stem's and the strided stages' shapes (and at
    odd and stride-1 ones), and JAX's output size."""
    assert resnet.same_pads(n, k, stride) == pads
    y = jax.lax.conv_general_dilated(jnp.zeros((1, n, n, 1)), jnp.zeros((k, k, 1, 1)),
                                     (stride, stride), "SAME",
                                     dimension_numbers=("NHWC", "HWIO", "NHWC"))
    assert y.shape[1] == (n + sum(pads) - k) // stride + 1


@pytest.mark.parametrize("hw", [(8, 8), (7, 7), (6, 9), (2, 2), (1, 1)])
def test_max_pool_matches_jax(hw):
    """All-negative inputs: padding with 0 instead of -inf would show."""
    x = -np.abs(np.random.default_rng(sum(hw)).standard_normal((2, *hw, 5))).astype(
        np.float32) - 1.0
    want = np.asarray(jax.lax.reduce_window(jnp.asarray(x), -jnp.inf, jax.lax.max,
                                            (1, 3, 3, 1), (1, 2, 2, 1), "SAME"))
    got = resnet.max_pool_same(torch.from_numpy(x))
    assert tuple(got.shape) == want.shape
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("c_in,c_mid", [(16, 4), (64, 16)])
def test_bottleneck_apply_matches_jax(c_in, c_mid, stride):
    """c_in == 4 c_mid: no shortcut conv (identity, subsampled at stride 2)."""
    dec = JDecomposer(J_NO_LRD, dtype=jnp.float32)
    p = _np(jresnet.bottleneck_init(dec, jax.random.PRNGKey(c_in + stride), "b", c_in,
                                    c_mid, jnp.float32))
    assert ("shortcut" in p) == (c_in != 4 * c_mid)
    x = np.random.default_rng(c_in).standard_normal((2, 7, 8, c_in)).astype(np.float32)
    want = np.asarray(jresnet.bottleneck_apply(p, jnp.asarray(x), stride))
    got = resnet.bottleneck_apply(bridge.from_numpy(p), torch.from_numpy(x), stride)
    assert _rel(got, want) <= OP_RTOL


# --------------------------------------------------------------------------
# ResNet-50
# --------------------------------------------------------------------------

@pytest.mark.parametrize("policy", ["none", "eq5", "alg1"])
def test_resnet_init_layout_and_plan_match_jax(policy):
    """The port's init (on the meta device: shapes only) against JAX's
    abstract init: the same leaves, shapes and plan."""
    tpol, jpol = {"none": (None, None), "eq5": (EQ5, J_EQ5), "alg1": (ALG1, J_ALG1)}[policy]
    jdec = JDecomposer(jpol, dtype=jnp.float32)
    jp = jax.eval_shape(lambda k: jresnet.resnet_init(k, "resnet50", 1000, jdec),
                        jax.random.PRNGKey(0))
    dec = Decomposer(tpol, dtype=torch.float32, device="meta")
    tp = resnet.resnet_init("resnet50", 1000, dec)
    assert jax.tree_util.tree_map(lambda t: tuple(t.shape), tp) == \
        jax.tree_util.tree_map(lambda a: a.shape, jp)
    assert json.loads(dec.plan.to_json()) == json.loads(jdec.plan.to_json())


def _err64(w, lp):
    """||W - W_r||^2 of a float64 truncated SVD (1x1 conv) or HOSVD (k x k,
    HWIO): the tail of the spectrum, or ||W||^2 - ||core||^2.  In torch,
    whose one thread this file pins: numpy's BLAS threads thrash under the
    suite's parallel workers."""
    w = torch.tensor(w, dtype=torch.float64)
    if lp.method == "svd":
        sigma = torch.linalg.svdvals(w.reshape(w.shape[-2:]))
        return torch.sum(sigma[lp.rank:] ** 2).item()
    wc = w.permute(2, 3, 0, 1)  # (C, S, k, k)
    c, s = wc.shape[:2]
    m0, m1 = wc.reshape(c, -1), wc.movedim(1, 0).reshape(s, -1)
    u = torch.linalg.eigh(m0 @ m0.T)[1][:, -lp.rank:]
    v = torch.linalg.eigh(m1 @ m1.T)[1][:, -lp.rank2:]
    core = torch.einsum("cskl,cp,sq->pqkl", wc, u, v)
    return (torch.sum(wc ** 2) - torch.sum(core ** 2)).item()


def test_apply_lrd_resnet50_matches_jax(trees):
    """The plan and layout of JAX's Eq.-5 init, and each layer's error
    against a float64 decomposition of the same weight."""
    dense, eq5, jplan = trees
    ttree, tplan = apply_lrd(bridge.from_numpy(dense), EQ5)
    renamed = {_init_path(p): dict(json.loads(tplan.to_json())[p], path=_init_path(p))
               for p in tplan.layers}
    assert renamed == json.loads(jplan.to_json())
    assert jax.tree_util.tree_map(lambda t: tuple(t.shape), ttree) == \
        jax.tree_util.tree_map(lambda a: a.shape, eq5)
    counts = {m: sum(lp.method == m for lp in tplan.layers.values()) for m in ("svd", "tucker")}
    assert counts == {"svd": 36, "tucker": 16}  # 1x1s, shortcuts and fc; 3x3s
    for path, lp in tplan.layers.items():
        w, g = _at(dense, path)["kernel"], _at(ttree, path)
        if lp.method == "tucker":
            err = tucker.tucker_reconstruction_error(
                torch.tensor(w).permute(2, 3, 0, 1), g["first"],
                g["core"].permute(2, 3, 0, 1), g["last"])
        else:
            err = svd.reconstruction_error(torch.tensor(w).reshape(w.shape[-2:]),
                                           g["u"], g["v"])
        norm = np.sum(w.astype(np.float64) ** 2)
        assert abs(err.item() - _err64(w, lp)) <= ERR_RTOL * norm, path


@pytest.mark.parametrize("which", ["dense", "eq5"])
def test_resnet50_logits_match_jax(trees, which):
    params = trees[0] if which == "dense" else trees[1]
    x = np.random.default_rng(1).standard_normal((2, 32, 32, 3)).astype(np.float32)
    want = np.asarray(jax.jit(functools.partial(jresnet.resnet_apply, variant="resnet50"))(
        params, x))
    got = resnet.resnet_apply(bridge.from_numpy(params), torch.from_numpy(x), "resnet50")
    assert tuple(got.shape) == want.shape == (2, 10)
    assert _rel(got, want) <= LOGITS_RTOL


def _bits(tree):
    """Leaves as raw bytes with their dtype and shape."""
    return [(p, a.dtype, a.shape, np.ascontiguousarray(a).tobytes()) for p, a in _leaves(tree)]


@pytest.mark.parametrize("which", ["resnet50", "resnet50_eq5_init", "resnet50_apply_lrd",
                                   "vit", "vit_apply_lrd", "vit_bf16"])
def test_bridge_carries_jax_trees_bit_for_bit(trees, which):
    """JAX's ResNet and ViT trees, dense and after JAX's apply_lrd (at
    ResNet-50's first block, where its HOSVD and SVDs are cheap), into the
    port and back through ``to_numpy``; bf16 leaves come back as float32,
    exactly."""
    if which.startswith("resnet50"):
        tree = {"resnet50": trees[0], "resnet50_eq5_init": trees[1]}.get(which)
        if tree is None:
            first_block = JPolicy(name="s0b0", rules=(
                JRule(r"s0b0/conv3x3", "tucker", min_dim=32),
                JRule(r"s0b0/(conv1x1|shortcut)", "svd", min_dim=32), JRule(r".*", "none")))
            tree = _np(j_apply_lrd(trees[0], first_block.with_quantize(False))[0])
            assert set(tree["s0b0"]["conv3x3"]) == {"first", "core", "last", "scale", "bn_bias"}
            assert "u" in tree["s0b0"]["shortcut"] and "kernel" in tree["s1b0"]["conv3x3"]
    else:
        dtype = jnp.bfloat16 if which == "vit_bf16" else jnp.float32
        tree = jvit.vit_init(jax.random.PRNGKey(4), JDecomposer(J_NO_LRD, dtype=dtype),
                             dtype=dtype, **VIT_SHAPE)
        if which == "vit_apply_lrd":
            tree = j_apply_lrd(tree, J_VIT)[0]
        tree = _np(tree)
    port = bridge.from_numpy(tree)
    if which == "vit_bf16":
        assert port["blocks"]["wi"]["kernel"].dtype == torch.bfloat16
        tree = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), tree)
    assert _bits(bridge.to_numpy(port)) == _bits(tree)


# --------------------------------------------------------------------------
# The paper's classification train step (benchmarks/table1_resnet_throughput.py
# and table4_vit.py, _train_step): its loss and gradients
# --------------------------------------------------------------------------

def _jax_loss(p, x, y, apply, phase):
    """The loss of the benchmarks' ``_train_step``."""
    if phase >= 0:
        p = jfreezing.apply_freeze(p, jfreezing.freeze_mask(p, phase))
    logits = apply(p, x)
    onehot = jax.nn.one_hot(y, logits.shape[-1])
    return -jnp.mean(jnp.sum(jax.nn.log_softmax(logits) * onehot, -1))


def _port_grads(params, x, y, apply, phase):
    """(loss, {path: grad or None}): frozen leaves detached by apply_freeze,
    so autograd never computes their gradient."""
    live = freezing.tree_map(lambda t: t.clone().requires_grad_(), bridge.from_numpy(params))
    p = freezing.apply_freeze(live, freezing.freeze_mask(live, phase)) if phase >= 0 else live
    with resnet.fp32_convs():
        loss = cross_entropy(apply(p, torch.from_numpy(x)), torch.from_numpy(y))
        loss.backward()
    return loss.item(), {path: leaf.grad for path, leaf in _leaves(live)}


def _model(which, trees):
    if which == "resnet50":
        return trees[1], functools.partial(jresnet.resnet_apply, variant="resnet50"), \
            functools.partial(resnet.resnet_apply, variant="resnet50"), 32
    dec = JDecomposer(J_NO_LRD, dtype=jnp.float32)
    dense = jvit.vit_init(jax.random.PRNGKey(4), dec, **VIT_SHAPE)
    kw = dict(heads=VIT_SHAPE["heads"], patch=VIT_SHAPE["patch"])
    return _np(j_apply_lrd(dense, J_VIT)[0]), functools.partial(jvit.vit_apply, **kw), \
        functools.partial(vit.vit_apply, **kw), VIT_SHAPE["img"]


@pytest.mark.parametrize("phase", [-1, 0, 1])
@pytest.mark.parametrize("which", ["resnet50", "vit"])
def test_classification_step_matches_jax(trees, which, phase):
    params, japply, tapply, img = _model(which, trees)
    rng = np.random.default_rng(7)
    x = rng.standard_normal((2, img, img, 3)).astype(np.float32)
    y = rng.integers(0, 10, size=(2,)).astype(np.int32)
    jloss, jgrads = jax.jit(jax.value_and_grad(
        functools.partial(_jax_loss, x=x, y=y, apply=japply, phase=phase)))(params)
    loss, grads = _port_grads(params, x, y, tapply, phase)
    assert abs(loss - float(jloss)) <= LOSS_RTOL * abs(float(jloss))
    frozen = {path for path, keep in _leaves(freezing.freeze_mask(params, phase)) if not keep}
    assert bool(frozen) == (phase >= 0)
    for path, jg in _leaves(_np(jgrads)):
        if path in frozen:
            assert grads[path] is None and not np.any(jg), path
        else:
            assert grads[path] is not None, path
            err = np.abs(grads[path].numpy().astype(np.float64) - jg).max()
            assert err <= GRAD_RTOL * np.abs(jg).max() + GRAD_ATOL, path
    want = {"resnet50": {-1: set(), 0: {"u", "first", "last"}, 1: {"v", "core"}},
            "vit": {-1: set(), 0: {"u"}, 1: {"v"}}}[which][phase]
    assert {path.rsplit("/", 1)[1] for path in frozen} == want
