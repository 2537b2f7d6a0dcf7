"""Activation checkpointing in the port (``lm_apply(..., remat=...)``, the
counterpart of the reference's ``_scan_stack``) on the smoke olmoe-1b-7b
(``moe_impl="ep"``) and smollm-360m at 4 layers, so that ``"sqrt"`` forms
2 groups of 2:

* each policy's loss and gradients equal ``"none"``'s bit for bit on the
  CPU, and JAX's train step under the same ``remat`` within 1e-5;
* the plain-version decisions of the factorised projections rise by the
  recomputed forwards only (the backward's are unchanged): ``"full"`` and
  ``"dots"`` run every layer's forward twice; ``"sqrt"`` three times,
  less the last layer of each group, whose output the group's recompute
  does not need (the non-reentrant checkpoint stops there); a prime
  layer count makes ``"sqrt"`` ``"full"``.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config
from repro.configs.base import DistConfig, LRDConfig, OptimConfig, RunConfig, ShapeConfig
from repro.data import LMBatchIterator
from repro.launch import steps as jsteps
from repro.launch.mesh import make_host_mesh
from repro_torch import bridge
from repro_torch.configs import get_smoke_config as t_get_smoke_config
from repro_torch.configs.base import DistConfig as TDist
from repro_torch.configs.base import LRDConfig as TLRD
from repro_torch.configs.base import OptimConfig as TOptim
from repro_torch.configs.base import RunConfig as TRun
from repro_torch.configs.base import ShapeConfig as TShape
from repro_torch.core import freezing
from repro_torch.kernels import ops
from repro_torch.launch import steps
from repro_torch.models import lm as tlm

torch.set_num_threads(1)

TOL = 1e-5  # float32 against JAX: the same products summed in another order
SEQ, BATCH = 16, 4
POLICIES = ("full", "dots", "sqrt")
ARCHS = ("olmoe-1b-7b", "smollm-360m")


def _runs(arch, remat="none", layers=4):
    kw = dict(num_layers=layers, **({"moe_impl": "ep"} if arch.startswith("olmoe") else {}))
    lrd = dict(enabled=True, min_dim=16, rank_quantize=False)
    opt = dict(name="sgdm", lr=1e-2, warmup_steps=2, total_steps=8)
    jrun = RunConfig(model=dataclasses.replace(get_smoke_config(arch), **kw),
                     shape=ShapeConfig("t", SEQ, BATCH, "train"), lrd=LRDConfig(**lrd),
                     dist=DistConfig(fsdp=False, remat=remat), optim=OptimConfig(**opt))
    trun = TRun(model=dataclasses.replace(t_get_smoke_config(arch), **kw),
                shape=TShape("t", SEQ, BATCH, "train"),
                lrd=TLRD(**lrd, use_pallas_kernel=True),
                dist=TDist(fsdp=False, remat=remat), optim=TOptim(**opt))
    return jrun, trun


@functools.lru_cache(maxsize=None)
def _params(arch, layers=4):
    jrun, _ = _runs(arch, layers=layers)
    return jax.tree_util.tree_map(np.asarray, jsteps.init_params(jrun, jax.random.PRNGKey(5))[0])


def _batch(arch):
    return next(iter(LMBatchIterator(get_smoke_config(arch).vocab_size, SEQ, BATCH, seed=2)))


def _grads(arch, remat, phase=-1, layers=4):
    """(loss, grads, plain-version decisions by op) of one port train step."""
    _, trun = _runs(arch, remat, layers)
    params = bridge.params_from_jax(_params(arch, layers))
    trainable, frozen = freezing.partition(params, phase)
    with ops.capture_fallbacks() as fbs:
        loss, grads = steps._value_and_grad(trainable, frozen,
                                            bridge.batch_from_numpy(_batch(arch)), trun, phase)
    counts = {}
    for f in fbs:
        counts[f.op] = counts.get(f.op, 0) + 1
    return loss, grads, counts


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("remat", POLICIES)
def test_remat_grads_equal_none_bitwise(remat, arch):
    loss0, g0, _ = _grads(arch, "none")
    loss, g, _ = _grads(arch, remat)
    assert torch.equal(loss, loss0)
    leaves0, leaves = freezing.tree_leaves(g0), freezing.tree_leaves(g)
    assert len(leaves) == len(leaves0) > 0
    assert all(torch.equal(a, b) for a, b in zip(leaves, leaves0))


@pytest.mark.parametrize("remat", POLICIES)
def test_remat_grads_match_jax_remat(remat):
    arch = "olmoe-1b-7b"
    jrun, _ = _runs(arch, remat)
    jstate, _ = jsteps.make_train_state(jrun.optim, _params(arch), -1)
    jnew, jm = jax.jit(functools.partial(jsteps.build_train_step(jrun, make_host_mesh(1, 1)),
                                         phase=-1))(
        jstate, {k: jnp.asarray(v) for k, v in _batch(arch).items()})
    loss, grads, _ = _grads(arch, remat)
    np.testing.assert_allclose(loss.item(), float(jm["loss"]), rtol=TOL, atol=TOL)
    got = bridge.to_numpy(grads)

    def flat(tree, path=""):
        if isinstance(tree, dict):
            return {k2: v2 for k, v in tree.items() for k2, v2 in flat(v, f"{path}/{k}").items()}
        return {path: np.asarray(tree)}

    want = flat(jnew.opt.mu)  # sgdm from zero momentum: the gradient
    got = flat(got)
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=TOL, atol=TOL, err_msg=k)


@pytest.mark.parametrize("remat,layers,arch", [
    ("full", 4, "olmoe-1b-7b"), ("dots", 4, "olmoe-1b-7b"), ("sqrt", 4, "olmoe-1b-7b"),
    ("sqrt", 3, "olmoe-1b-7b"), ("sqrt", 4, "smollm-360m")])
def test_remat_adds_recomputed_forwards_only(remat, layers, arch):
    _, trun = _runs(arch, layers=layers)
    with ops.capture_fallbacks() as fbs, torch.no_grad():  # one forward's decisions
        tlm.lm_apply(bridge.params_from_jax(_params(arch, layers)),
                     torch.from_numpy(_batch(arch)["tokens"]), trun.model, mode="train",
                     policy=True)
    fwd = {}
    for f in fbs:
        fwd[f.op] = fwd.get(f.op, 0) + 1
    _, _, base = _grads(arch, "none", layers=layers)
    _, _, got = _grads(arch, remat, layers=layers)
    groups = tlm._best_divisor(layers) if remat == "sqrt" else 1
    per = layers // groups
    # forwards a layer runs beyond the first: its recompute, and under sqrt
    # the group's recompute for all but the group's last layer
    extra = 1 if groups == 1 else 1 + (per - 1) / per
    assert fwd and set(base) >= set(fwd)
    for op, n in base.items():
        assert got[op] == n + fwd.get(op, 0) * extra, (op, got, base, fwd)
    assert tlm._best_divisor(16) == 4 and tlm._best_divisor(3) == 1


def test_unknown_remat_policy_raises():
    _, trun = _runs("olmoe-1b-7b")
    params = bridge.params_from_jax(_params("olmoe-1b-7b"))
    with pytest.raises(ValueError, match="remat"):
        tlm.lm_apply(params, torch.zeros((1, 4), dtype=torch.int32), trun.model,
                     mode="train", remat="everything")
