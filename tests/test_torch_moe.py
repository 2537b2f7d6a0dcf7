"""The port's MoE layer (``repro_torch.models.moe``) against the JAX
package's ``repro.models.moe`` on the same weights (made in JAX, carried
over by ``repro_torch.bridge``) and the same numpy inputs: the router, the
expert FFN (dense and LRD experts) and ``moe_apply`` under the ``dense``,
``gshard`` and one-device ``ep`` dispatch, where the JAX side runs ``ep``
as its entry points do, inside ``axis_rules`` of a 1 x 1 host mesh.
float32 within 1e-5, plus one bfloat16 case."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config
from repro.core.decompose import Decomposer
from repro.core.policy import LM_DEFAULT, NO_LRD
from repro.distributed.sharding import axis_rules
from repro.launch.mesh import make_host_mesh
from repro.models import moe as jmoe
from repro_torch import bridge
from repro_torch.configs import get_smoke_config as t_get_smoke_config
from repro_torch.models import moe as tmoe

torch.set_num_threads(1)

TOL = 1e-5  # float32: the same products summed in another order
IMPLS = ("dense", "gshard", "ep")
# (E, k, t, d, f): the smoke config's routing, and OLMoE's 64 experts top-8
# at an 8-token step, where the ep path's stage-2 capacity is 1
SIZES = {"smoke": (8, 2, 64, 32, 16), "olmoe-decode": (64, 8, 8, 32, 16)}


def _cfgs(e, k, d, f, impl="ep"):
    kw = dict(num_experts=e, num_experts_per_tok=k, d_model=d, moe_d_ff=f, moe_impl=impl)
    return (dataclasses.replace(get_smoke_config("olmoe-1b-7b"), **kw),
            dataclasses.replace(t_get_smoke_config("olmoe-1b-7b"), **kw))


def _layer(size, lrd, dtype=jnp.float32, seed=0):
    """(JAX params, torch params, x numpy (2, t/2, d)) of one MoE layer."""
    e, k, t, d, f = SIZES[size]
    jcfg, _ = _cfgs(e, k, d, f)
    policy = LM_DEFAULT.with_quantize(False).with_min_dim(8) if lrd else NO_LRD
    p = jmoe.moe_init(Decomposer(policy, dtype=dtype), jax.random.PRNGKey(seed), "moe", jcfg)
    assert ("u" in p["experts"]["gate"]) == lrd
    x = np.asarray(jax.random.normal(jax.random.PRNGKey(seed + 1), (2, t // 2, d)) * 0.3)
    return p, bridge.params_from_jax(jax.tree_util.tree_map(np.asarray, p)), x


def _jax_moe(p, x, cfg):
    """JAX ``moe_apply`` inside a 1 x 1 mesh's axis rules, jitted (shard_map
    runs op by op otherwise)."""
    with axis_rules(make_host_mesh(1, 1)):
        return jax.jit(lambda p, x: jmoe.moe_apply(p, x, cfg))(p, jnp.asarray(x))


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got, np.float32), np.asarray(want, np.float32),
                               rtol=0, atol=tol)


def _kept_pairs(topi: torch.Tensor, cap: int) -> int:
    """Pairs under ``cap`` in flat order per expert (the ep stage-2 rule)."""
    counts, kept = {}, 0
    for e in topi.reshape(-1).tolist():
        kept += counts.get(e, 0) < cap
        counts[e] = counts.get(e, 0) + 1
    return kept


@pytest.mark.parametrize("size", sorted(SIZES))
def test_router_matches_jax(size):
    e, k, t, d, f = SIZES[size]
    jcfg, tcfg = _cfgs(e, k, d, f)
    p, tp, x = _layer(size, lrd=False)
    xf = x.reshape(t, d)
    jw, ji, jaux = jmoe._router(p, jnp.asarray(xf), jcfg)
    tw, ti, taux = tmoe._router(tp, torch.from_numpy(xf), tcfg)
    assert ti.tolist() == np.asarray(ji).tolist()
    _close(tw.numpy(), jw)
    _close(taux.item(), float(jaux))
    # the reference's load-balance term is a constant: ce = 1/E, aux = sum(me)
    assert abs(taux.item() - 1.0) < 1e-6

    def jaux_of(w):
        return jmoe._router({"router": {"kernel": w}}, jnp.asarray(xf), jcfg)[2]

    jg = jax.grad(jaux_of)(p["router"]["kernel"])
    w = tp["router"]["kernel"].clone().requires_grad_(True)
    taux = tmoe._router({"router": {"kernel": w}}, torch.from_numpy(xf), tcfg)[2]
    (tg,) = torch.autograd.grad(taux, w)
    assert float(np.abs(np.asarray(jg)).max()) < 1e-6 and tg.abs().max().item() < 1e-6


@pytest.mark.parametrize("lrd", [False, True])
def test_expert_ffn_matches_jax(lrd):
    p, tp, _ = _layer("smoke", lrd)
    x_e = np.asarray(jax.random.normal(jax.random.PRNGKey(5), (8, 6, 32)) * 0.5)
    want = jmoe._expert_ffn(p["experts"], jnp.asarray(x_e))
    got = tmoe._expert_ffn(tp["experts"], torch.from_numpy(x_e))
    _close(got.numpy(), want)


@pytest.mark.parametrize("lrd", [False, True])
@pytest.mark.parametrize("size", sorted(SIZES))
@pytest.mark.parametrize("impl", IMPLS)
def test_moe_apply_matches_jax(impl, size, lrd):
    e, k, t, d, f = SIZES[size]
    jcfg, tcfg = _cfgs(e, k, d, f, impl)
    p, tp, x = _layer(size, lrd)
    jy, jaux = _jax_moe(p, x, jcfg)
    ty, taux = tmoe.moe_apply(tp, torch.from_numpy(x), tcfg)
    assert ty.shape == x.shape and ty.dtype == torch.float32
    _close(ty.numpy(), jy)
    _close(taux.item(), float(jaux))
    if impl == "ep" and size == "olmoe-decode":
        # cap2 = 1: every expert keeps only its first pair in flat order
        assert tmoe.ep_capacity(t, tcfg) == 1
        topi = tmoe._router(tp, torch.from_numpy(x).reshape(t, d), tcfg)[1]
        assert _kept_pairs(topi, 1) < t * k


def test_idle_lane_takes_capacity_as_in_jax():
    """Every row is routed and takes ep capacity, an idle decode lane (or a
    padded prefill row) too: with an idle lane in slot 0 ahead of seven live
    ones, the live lanes' outputs differ from a step over the live lanes
    alone, in both packages alike (cap2 = 1 either way)."""
    e, k, t, d, f = SIZES["olmoe-decode"]
    jcfg, tcfg = _cfgs(e, k, d, f, "ep")
    p, tp, x = _layer("olmoe-decode", lrd=True)
    lanes = x.reshape(t, 1, d)  # eight one-token lanes, lane 0 idle
    outs = []
    for xx in (lanes, lanes[1:]):
        xx = np.ascontiguousarray(xx)
        jy, _ = _jax_moe(p, xx, jcfg)
        ty, _ = tmoe.moe_apply(tp, torch.from_numpy(xx), tcfg)
        _close(ty.numpy(), jy)
        outs.append(ty)
    assert tmoe.ep_capacity(t - 1, tcfg) == tmoe.ep_capacity(t, tcfg) == 1
    assert not torch.equal(outs[0][1:], outs[1])


@pytest.mark.parametrize("impl", IMPLS)
def test_moe_grads_match_jax(impl):
    """Gradients of sum(y * w) w.r.t. x, the router and the LRD experts at
    the cap2 = 1 size (dropped pairs carry no gradient in either)."""
    e, k, t, d, f = SIZES["olmoe-decode"]
    jcfg, tcfg = _cfgs(e, k, d, f, impl)
    p, tp, x = _layer("olmoe-decode", lrd=True)
    wts = np.random.default_rng(2).standard_normal(x.shape).astype(np.float32)

    def jloss(p, x):
        y, aux = _jax_moe(p, x, jcfg)
        return jnp.sum(y * wts) + 0.01 * aux

    jgp, jgx = jax.grad(jloss, argnums=(0, 1))(p, jnp.asarray(x))
    leaves = [("router", tp["router"]["kernel"])] + [
        (f"{g}/{n}", tp["experts"][g][n]) for g in ("gate", "up", "down") for n in ("u", "v")]
    live = [t_.clone().requires_grad_(True) for _, t_ in leaves]
    tx = torch.from_numpy(x).requires_grad_(True)
    tree = {"router": {"kernel": live[0]},
            "experts": {g: {"u": live[1 + 2 * i], "v": live[2 + 2 * i]}
                        for i, g in enumerate(("gate", "up", "down"))}}
    y, aux = tmoe.moe_apply(tree, tx, tcfg)
    loss = torch.sum(y * torch.from_numpy(wts)) + 0.01 * aux
    grads = torch.autograd.grad(loss, live + [tx])
    _close(grads[-1].numpy(), jgx)
    for (name, _), g in zip(leaves, grads[:-1]):
        want = (jgp["router"]["kernel"] if name == "router"
                else jgp["experts"][name.split("/")[0]][name.split("/")[1]])
        _close(g.numpy(), want)


def test_ep_bf16_matches_jax():
    """bfloat16 weights and activations under ep at the cap2 = 1 size.
    Both packages round after each expert product and sum a token's k
    contributions in slot order in bf16; the float32 sums inside a product
    run in another order, which can flip a bf16 rounding of an
    intermediate by one ulp.  Such a flip moves y by about one bf16 ulp
    (2**-8 relative) of the element it lands on, so the bound is 2 ulps of
    max |y|; routing is decided in float32 on the same bf16 inputs, so the
    expert ids must agree exactly."""
    e, k, t, d, f = SIZES["olmoe-decode"]
    jcfg, tcfg = _cfgs(e, k, d, f, "ep")
    p, tp, x = _layer("olmoe-decode", lrd=True, dtype=jnp.bfloat16)
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    jy, _ = _jax_moe(p, xb, jcfg)
    ty, _ = tmoe.moe_apply(tp, bridge.from_numpy(np.asarray(xb)), tcfg)
    assert ty.dtype == torch.bfloat16
    want = np.asarray(jy.astype(jnp.float32))
    got = ty.float().numpy()
    bound = 2 * 2.0 ** -8 * np.abs(want).max()
    assert np.abs(got - want).max() <= bound, (np.abs(got - want).max(), bound)
    ji = jmoe._router(p, xb.reshape(t, d), jcfg)[1]
    ti = tmoe._router(tp, bridge.from_numpy(np.asarray(xb)).reshape(t, d), tcfg)[1]
    assert ti.tolist() == np.asarray(ji).tolist()


@pytest.mark.parametrize("impl", IMPLS)
def test_shared_expert_matches_jax(impl):
    """A config with a shared expert (DeepSeek's layout) adds the shared
    SwiGLU FFN to every token's routed output, in both packages."""
    e, k, t, d, f = SIZES["smoke"]
    jcfg, tcfg = (dataclasses.replace(c, num_shared_experts=1) for c in _cfgs(e, k, d, f, impl))
    p = jmoe.moe_init(Decomposer(LM_DEFAULT.with_quantize(False).with_min_dim(8),
                                 dtype=jnp.float32), jax.random.PRNGKey(3), "moe", jcfg)
    assert "shared" in p
    tp = bridge.params_from_jax(jax.tree_util.tree_map(np.asarray, p))
    x = np.asarray(jax.random.normal(jax.random.PRNGKey(4), (2, t // 2, d)) * 0.3)
    jy, _ = _jax_moe(p, x, jcfg)
    ty, _ = tmoe.moe_apply(tp, torch.from_numpy(x), tcfg)
    _close(ty.numpy(), jy)


def test_unknown_impl_and_int8_experts_raise():
    e, k, t, d, f = SIZES["smoke"]
    _, tcfg = _cfgs(e, k, d, f, "ragged")
    _, tp, x = _layer("smoke", lrd=True)
    with pytest.raises(ValueError, match="moe_impl"):
        tmoe.moe_apply(tp, torch.from_numpy(x), tcfg)
    int8 = dict(tp, experts={g: {"u_q": v["u"], "v_q": v["v"]}
                             for g, v in tp["experts"].items()})
    with pytest.raises(ValueError, match="int8 export of expert groups"):
        tmoe.moe_apply(int8, torch.from_numpy(x), dataclasses.replace(tcfg, moe_impl="ep"))
