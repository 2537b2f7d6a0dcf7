"""The training slice's small modules against their JAX counterparts:
``core.freezing`` (partitions, phases, the guard), ``optim`` (schedules and
one update of each optimizer), ``data.synthetic`` (the same batches from
the same seed) and ``models.common.cross_entropy``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import OptimConfig
from repro.core import freezing as jfreezing
from repro.data import LMBatchIterator as JLMBatchIterator
from repro.models.common import cross_entropy as jcross_entropy
from repro.optim import optimizers as jopt
from repro_torch import bridge
from repro_torch.configs.base import OptimConfig as TOptimConfig
from repro_torch.core import freezing
from repro_torch.data import LMBatchIterator
from repro_torch.models.common import cross_entropy
from repro_torch.optim import optimizers as topt

torch.set_num_threads(1)

TOL = 1e-6  # float32 elementwise arithmetic in the same order


def _params():
    rng = np.random.default_rng(0)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    return {"embed": {"embedding": f(8, 4)},
            "stack": {"attn": {"wq": {"u": f(2, 4, 3), "v": f(2, 3, 4)},
                               "wk": {"kernel": f(2, 4, 4), "bias": f(2, 4)}},
                      "tucker": {"first": f(3, 2), "core": f(2, 2), "last": f(2, 3)}},
            "final_norm": {"scale": f(4)}}


def _holes(tree):
    """The tree's structure with True at leaves and None at holes."""
    if isinstance(tree, dict):
        return {k: _holes(v) for k, v in tree.items()}
    return None if tree is None else True


@pytest.mark.parametrize("phase", [-1, 0, 1])
def test_partition_merge_and_guard_match_jax(phase):
    params = _params()
    jtr, jfr = jfreezing.partition(params, phase)
    ttr, tfr = freezing.partition(bridge.from_numpy(params), phase)
    assert _holes(ttr) == _holes(jtr) and _holes(tfr) == _holes(jfr)
    assert freezing.phase_of_partition(ttr, tfr) == jfreezing.phase_of_partition(jtr, jfr)
    assert freezing.freeze_mask(params, phase) == jfreezing.freeze_mask(params, phase)
    merged = freezing.merge(ttr, tfr)
    assert _holes(merged) == _holes(params)
    for a, b in zip(freezing.tree_leaves(merged), freezing.tree_leaves(params)):
        np.testing.assert_array_equal(a.numpy(), b)
    freezing.check_partition(ttr, tfr, phase)
    for other in {-1, 0, 1} - {phase}:
        with pytest.raises(ValueError, match="partition/phase mismatch"):
            freezing.check_partition(ttr, tfr, other)
    mu = bridge.from_numpy(params)
    (mu_a, nu_a), (mu_p, nu_p) = freezing.partition_moments((mu, ()), phase)
    assert nu_a == () and nu_p == () and _holes(mu_a) == _holes(jtr)
    assert _holes(freezing.merge_moments((mu_a, ()), (mu_p, ()))[0]) == _holes(params)


def test_phase_schedule_matches_jax():
    for mode in ("none", "regular", "sequential"):
        for cadence in (1, 2):
            got = [freezing.phase_for_epoch(e, mode, cadence) for e in range(6)]
            assert got == [jfreezing.phase_for_epoch(e, mode, cadence) for e in range(6)]
    for old in (-1, 0, 1):
        assert freezing.frozen_group_for_phase(old) == jfreezing.frozen_group_for_phase(old)
        for new in (-1, 0, 1):
            assert freezing.groups_to_replace(old, new) == jfreezing.groups_to_replace(old, new)


@pytest.mark.parametrize("schedule", ["cosine", "linear", "constant"])
def test_lr_schedule_matches_jax(schedule):
    kw = dict(lr=3e-3, warmup_steps=3, total_steps=11, schedule=schedule)
    jsched, tsched = jopt.make_schedule(OptimConfig(**kw)), topt.make_schedule(TOptimConfig(**kw))
    for step in range(14):
        want = float(jsched(jnp.asarray(step, jnp.int32)))
        got = float(tsched(torch.tensor(step, dtype=torch.int32)))
        assert abs(got - want) <= TOL * max(abs(want), 1e-3), (step, got, want)


@pytest.mark.parametrize("name,state_dtype", [("sgdm", "float32"), ("adamw", "float32"),
                                              ("adamw", "bfloat16")])
def test_one_update_matches_jax(name, state_dtype):
    kw = dict(name=name, lr=1e-2, warmup_steps=2, total_steps=8, state_dtype=state_dtype)
    params = {"a": _params()["stack"]["attn"]["wq"], "b": None}
    rng = np.random.default_rng(1)
    grads = jax.tree_util.tree_map(lambda p: rng.standard_normal(p.shape).astype(np.float32),
                                   params)
    jstate = jopt.init_optimizer(OptimConfig(**kw), params)
    jstate = jstate._replace(step=jnp.asarray(4, jnp.int32))
    jp, js = jopt.apply_updates(OptimConfig(**kw), params, grads, jstate)
    tstate = topt.init_optimizer(TOptimConfig(**kw), bridge.from_numpy(params))
    assert _holes(tstate.mu) == _holes(jstate.mu)
    tstate = tstate._replace(step=torch.tensor(4, dtype=torch.int32))
    tp, ts = topt.apply_updates(TOptimConfig(**kw), bridge.from_numpy(params),
                                bridge.from_numpy(grads), tstate)
    assert int(ts.step) == int(js.step) == 5
    for got, want in zip(freezing.tree_leaves((tp, ts.mu, ts.nu)),
                         jax.tree_util.tree_leaves((jp, js.mu, js.nu))):
        assert str(got.dtype).split(".")[-1] == str(want.dtype)
        np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                                   rtol=TOL, atol=TOL)
    parked = topt.init_moments(TOptimConfig(**kw), bridge.from_numpy(params), on_host=True)
    assert all(t.device.type == "cpu" for t in freezing.tree_leaves(parked))
    assert (parked[1] == ()) == (name == "sgdm")


def test_synthetic_batches_match_jax():
    mine, ref = LMBatchIterator(300, 12, 4, seed=5), JLMBatchIterator(300, 12, 4, seed=5)
    for a, b in zip((next(iter(mine)) for _ in range(3)), (next(iter(ref)) for _ in range(3))):
        for k in ("tokens", "labels"):
            np.testing.assert_array_equal(a[k], b[k])
    assert mine.state_dict() == ref.state_dict()


@pytest.mark.parametrize("masked", [False, True])
def test_cross_entropy_matches_jax(masked):
    rng = np.random.default_rng(2)
    logits = (rng.standard_normal((2, 5, 17)) * 3).astype(np.float32)
    labels = rng.integers(0, 17, (2, 5)).astype(np.int32)
    mask = (rng.random((2, 5)) < 0.6).astype(np.float32) if masked else None
    want = jcross_entropy(jnp.asarray(logits), jnp.asarray(labels),
                          None if mask is None else jnp.asarray(mask))
    got = cross_entropy(torch.from_numpy(logits), torch.from_numpy(labels),
                        None if mask is None else torch.from_numpy(mask))
    np.testing.assert_allclose(got.item(), float(want), rtol=TOL, atol=TOL)
