"""The port's ViT and its parts against the JAX package on the same numpy
inputs and JAX-made parameters: ``layernorm``, ``vit_init``'s layout, plan
and tied q/k/v init, ``vit_apply`` (2 layers, d 96, 3 heads, d_ff 384,
patch 8, 32 x 32; dense and through the benchmarks' ViT policy), a GELU
check that the erf form would fail, and ``SyntheticClassification``'s
batches, bit for bit.  The ViT's loss and gradients under freezing are in
``test_torch_resnet.py`` beside ResNet-50's.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.decompose import Decomposer as JDecomposer
from repro.core.decompose import apply_lrd as j_apply_lrd
from repro.core.policy import NO_LRD as J_NO_LRD
from repro.core.policy import DecompositionPolicy as JPolicy
from repro.core.policy import Rule as JRule
from repro.data import SyntheticClassification as JSyntheticClassification
from repro.models import common as jcommon
from repro.models import vit as jvit
from repro_torch import bridge
from repro_torch.core.decompose import Decomposer
from repro_torch.core.policy import DecompositionPolicy, Rule
from repro_torch.data import SyntheticClassification
from repro_torch.models import common, vit

torch.set_num_threads(1)

# max |port - jax| / max |jax| in float32: layernorm's statistics and the
# ViT's logits (a few hundred-term float32 sums in another order per layer)
LN_RTOL = 1e-6
LOGITS_RTOL = 1e-5
# erf- against tanh-GELU logits on the GELU check's model: the two forms
# differ by up to 5e-4 at a pre-activation near 2, which moves these logits
# by 1.8e-4 of their max (a CPU run), 18x LOGITS_RTOL
ERF_GAP = 10 * LOGITS_RTOL

SHAPE = dict(num_layers=2, d=96, heads=3, d_ff=384, patch=8, img=32)
KW = dict(heads=3, patch=8)
# the ViT policy of benchmarks/table4_vit.py:19-26
J_VIT = JPolicy(name="vit-ffn", rules=(
    JRule(r"(norm|bias|pos_emb|cls|head)", "none"),
    JRule(r"(wi|down|patch_embed)", "svd", min_dim=32), JRule(r".*", "none")))
VIT = DecompositionPolicy(name="vit-ffn", rules=(
    Rule(r"(norm|bias|pos_emb|cls|head)", "none"),
    Rule(r"(wi|down|patch_embed)", "svd", min_dim=32), Rule(r".*", "none")))


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / np.abs(want).max()


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _images(seed, b=2, img=32):
    return np.random.default_rng(seed).standard_normal((b, img, img, 3)).astype(np.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layernorm_matches_jax(dtype):
    rng = np.random.default_rng(0)
    x = (rng.standard_normal((3, 5, 48)) * 3 + 1).astype(np.float32)
    p = {"scale": rng.uniform(0.5, 1.5, 48).astype(np.float32),
         "ln_bias": rng.standard_normal(48).astype(np.float32)}
    jdt = jnp.dtype(dtype)
    want = np.asarray(jcommon.layernorm(p, jnp.asarray(x).astype(jdt)).astype(jnp.float32))
    got = common.layernorm(bridge.from_numpy(p), torch.from_numpy(x).to(getattr(torch, dtype)))
    assert got.dtype == getattr(torch, dtype)
    # bf16 in and out: the same float32 statistics, one bf16 rounding
    assert _rel(got.float(), want) <= (LN_RTOL if dtype == "float32" else 2 ** -8)
    init = common.layernorm_init(48, torch.float32, "cpu", (2,))
    assert {k: tuple(v.shape) for k, v in init.items()} == {"scale": (2, 48), "ln_bias": (2, 48)}
    assert set(init) == set(jcommon.layernorm_init(48, jnp.float32))


@pytest.mark.parametrize("policy", ["none", "vit"])
def test_vit_init_layout_plan_and_tied_qkv(policy):
    tpol, jpol = {"none": (None, None), "vit": (VIT, J_VIT)}[policy]
    jdec = JDecomposer(jpol, dtype=jnp.float32)
    jp = jax.eval_shape(lambda k: jvit.vit_init(k, jdec, **SHAPE), jax.random.PRNGKey(0))
    dec = Decomposer(tpol, dtype=torch.float32, generator=torch.Generator().manual_seed(0))
    tp = vit.vit_init(dec, **SHAPE)
    assert jax.tree_util.tree_map(lambda t: tuple(t.shape), tp) == \
        jax.tree_util.tree_map(lambda a: a.shape, jp)
    assert json.loads(dec.plan.to_json()) == json.loads(jdec.plan.to_json())
    # JAX draws wq, wk and wv from one key: they start equal, in both
    blocks = tp["blocks"]
    for name in ("wk", "wv"):
        assert torch.equal(blocks[name]["kernel"], blocks["wq"]["kernel"])
    jreal = jvit.vit_init(jax.random.PRNGKey(0), JDecomposer(J_NO_LRD, dtype=jnp.float32),
                          **SHAPE)["blocks"]
    np.testing.assert_array_equal(np.asarray(jreal["wk"]["kernel"]),
                                  np.asarray(jreal["wq"]["kernel"]))
    assert not torch.equal(blocks["wo"]["kernel"], blocks["wq"]["kernel"])
    # without a generator of its own, the device's default one is tied too
    free = vit.vit_init(Decomposer(None, dtype=torch.float32), **SHAPE)["blocks"]
    assert torch.equal(free["wv"]["kernel"], free["wq"]["kernel"])


@pytest.mark.parametrize("which", ["dense", "vit"])
def test_vit_logits_match_jax(which):
    dense = jvit.vit_init(jax.random.PRNGKey(1), JDecomposer(J_NO_LRD, dtype=jnp.float32),
                          **SHAPE)
    params = _np(dense if which == "dense" else j_apply_lrd(dense, J_VIT)[0])
    assert ("u" in params["blocks"]["wi"]) == (which == "vit")
    x = _images(2)
    want = np.asarray(jax.jit(lambda p, x: jvit.vit_apply(p, x, **KW))(params, x))
    got = vit.vit_apply(bridge.from_numpy(params), torch.from_numpy(x), **KW)
    assert tuple(got.shape) == want.shape == (2, 10)
    assert _rel(got, want) <= LOGITS_RTOL


def test_vit_gelu_is_the_tanh_form(monkeypatch):
    """On a ViT whose FFN pre-activations have a standard deviation of 2,
    the port matches JAX's (tanh) GELU within LOGITS_RTOL and misses the
    erf form by more than ERF_GAP."""
    dense = _np(jvit.vit_init(jax.random.PRNGKey(2), JDecomposer(J_NO_LRD, dtype=jnp.float32),
                              **SHAPE))
    dense["blocks"]["wi"]["kernel"] = dense["blocks"]["wi"]["kernel"] * 2.0
    x = _images(3)
    got = vit.vit_apply(bridge.from_numpy(dense), torch.from_numpy(x), **KW)
    tanh = np.asarray(jvit.vit_apply(dense, jnp.asarray(x), **KW))
    monkeypatch.setattr(jax.nn, "gelu", lambda v: 0.5 * v * (
        1.0 + jax.scipy.special.erf(v / np.sqrt(2.0))))
    erf = np.asarray(jvit.vit_apply(dense, jnp.asarray(x), **KW))
    assert _rel(got, tanh) <= LOGITS_RTOL
    assert _rel(got, erf) > ERF_GAP


@pytest.mark.parametrize("img,batch,classes", [(32, 8, 10), (16, 3, 1000)])
def test_synthetic_classification_matches_jax(img, batch, classes):
    port = SyntheticClassification(num_classes=classes, img=img, batch=batch, seed=5)
    ref = JSyntheticClassification(num_classes=classes, img=img, batch=batch, seed=5)
    for _ in range(3):
        (x, y), (jx, jy) = port.next_batch(), ref.next_batch()
        assert x.dtype == jx.dtype == np.float32 and y.dtype == jy.dtype == np.int32
        np.testing.assert_array_equal(x, jx)
        np.testing.assert_array_equal(y, jy)
    assert port.step == ref.step == 3
    for a, b in zip(port.eval_batch(16), ref.eval_batch(16)):
        np.testing.assert_array_equal(a, b)
