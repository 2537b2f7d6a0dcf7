"""Algorithm 1 in the port against the JAX package: ``quantize_rank``,
``optimize_rank`` (analytic at stride 1 and 32, and the measured backend's
sweep), ``RankResolver.svd_rank(rank_quantize=True)`` at the full-width
smollm-360m geometries and the smoke ones, ``truncate_factors`` and
``product_singular_values`` on the same factors, and the train CLI
building the JAX plan when ``--no-rank-opt`` is not given."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config
from repro.configs.base import DistConfig, LRDConfig, RunConfig, ShapeConfig
from repro.core import rank_opt as jro
from repro.core import svd as jsvd
from repro.core.decompose import RankResolver as JResolver
from repro.core.policy import LM_DEFAULT as J_LM_DEFAULT
from repro.launch import steps as jsteps
from repro_torch.core import rank_opt as tro
from repro_torch.core import svd as tsvd
from repro_torch.core.decompose import RankResolver as TResolver
from repro_torch.core.policy import LM_DEFAULT as T_LM_DEFAULT

torch.set_num_threads(1)

# (C, S) of full-width smollm-360m (wq/wo, wk/wv, gate/up, down) and of its
# smoke config, and the Algorithm-1 ranks JAX's RankResolver builds at
# full width
FULL = [(960, 960), (960, 320), (960, 2560), (2560, 960)]
FULL_RANKS = {(960, 960): 239, (960, 320): 80, (960, 2560): 256, (2560, 960): 256}
SMOKE = [(64, 64), (64, 32), (64, 128), (128, 64)]


@pytest.mark.parametrize("tile", [8, 32, 128])
@pytest.mark.parametrize("mode", ["floor", "nearest"])
def test_quantize_rank_matches_jax(tile, mode):
    for r in range(1, 700):
        assert tro.quantize_rank(r, tile=tile, mode=mode) == jro.quantize_rank(
            r, tile=tile, mode=mode)


def _same_decision(a, b):
    assert (a.rank, a.use_decomposed) == (b.rank, b.use_decomposed)
    assert tuple(a.searched) == tuple(b.searched)
    assert a.original_time == b.original_time and a.decomposed_time == b.decomposed_time
    assert tuple(a.times) == tuple(b.times)


@pytest.mark.parametrize("stride", [1, 32])
@pytest.mark.parametrize("m", [8, 4096])
@pytest.mark.parametrize("cs", FULL + SMOKE)
def test_optimize_rank_analytic_matches_jax(cs, m, stride):
    c, s = cs
    for alpha in (2.0, 3.0):
        _same_decision(tro.optimize_rank(c, s, alpha=alpha, m=m, stride=stride),
                       jro.optimize_rank(c, s, alpha=alpha, m=m, stride=stride))


@pytest.mark.parametrize("stride", [1, 7])
def test_optimize_rank_measured_matches_jax_on_the_same_times(stride):
    """The same time_fn through both: the same searched ranks, refinement and
    guard (a staircase with cliffs every 16 ranks and a dense time between)."""
    def staircase(r):
        return 1.0 if r is None else 0.5 + 0.1 * (-(-r // 16))

    for c, s in FULL:
        _same_decision(
            tro.optimize_rank(c, s, m=8, backend="measured", time_fn=staircase, stride=stride),
            jro.optimize_rank(c, s, m=8, backend="measured", time_fn=staircase, stride=stride))


def test_measured_backend_on_cpu_searches_the_same_ranks():
    c, s = 96, 64
    fn = tro.measured_linear_time_fn(c, s, m=4, iters=2, device="cpu")
    assert fn(None) >= 0.0 and fn(8) >= 0.0
    got = tro.optimize_rank(c, s, m=4, backend="measured", time_fn=fn)
    want = jro.optimize_rank(c, s, m=4, backend="measured",
                             time_fn=jro.measured_linear_time_fn(c, s, m=4, iters=2))
    assert tuple(got.searched) == tuple(want.searched)
    assert got.searched[0] <= got.rank <= got.searched[-1]
    with pytest.raises(ValueError, match="time_fn"):
        tro.optimize_rank(c, s, backend="measured")


@pytest.mark.parametrize("cs", FULL + SMOKE)
def test_rank_resolver_algorithm_1_matches_jax(cs):
    c, s = cs
    for quantize in (True, False):
        jrule = J_LM_DEFAULT.with_quantize(quantize).with_min_dim(16).match("layers/attn/wq")
        trule = T_LM_DEFAULT.with_quantize(quantize).with_min_dim(16).match("layers/attn/wq")
        _same_decision(TResolver().svd_rank(c, s, trule), JResolver().svd_rank(c, s, jrule))
    if cs in FULL_RANKS:
        trule = T_LM_DEFAULT.with_min_dim(16).match("layers/attn/wq")
        assert trule.rank_quantize
        assert TResolver().svd_rank(c, s, trule).rank == FULL_RANKS[cs]


def _factors(seed, shape_u, shape_v):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape_u).astype(np.float32),
            rng.standard_normal(shape_v).astype(np.float32) * 0.1)


@pytest.mark.parametrize("lead", [(), (3,)])
@pytest.mark.parametrize("c,r,s,rank", [(40, 16, 24, 8), (24, 12, 48, 5), (64, 21, 64, 16)])
def test_truncate_factors_matches_jax(lead, c, r, s, rank):
    u, v = _factors(c + r + s, lead + (c, r), lead + (r, s))
    tu0, tv0 = torch.from_numpy(u), torch.from_numpy(v)
    tu, tv = tsvd.truncate_factors(tu0, tv0, rank)
    ju, jv = jsvd.truncate_factors(jnp.asarray(u), jnp.asarray(v), rank)
    assert tuple(tu.shape) == tuple(ju.shape) == lead + (c, rank)
    got = (tu @ tv).numpy()
    want = np.asarray(jnp.matmul(ju, jv))
    np.testing.assert_allclose(got, want, atol=1e-4 * np.abs(want).max(), rtol=0)
    sv_t = tsvd.product_singular_values(tu0, tv0).numpy()
    sv_j = np.asarray(jsvd.product_singular_values(jnp.asarray(u), jnp.asarray(v)))
    np.testing.assert_allclose(sv_t, sv_j, rtol=1e-4, atol=1e-4 * sv_j.max())
    # rank >= r leaves the factors as they are
    assert tsvd.truncate_factors(tu0, tv0, r) == (tu0, tv0)


def test_compression_ratio_matches_jax():
    for c, s in FULL + SMOKE:
        for r in (1, 7, 64, min(c, s)):
            assert tsvd.svd_compression_ratio(c, s, r) == jsvd.svd_compression_ratio(c, s, r)


def _plan(plan):
    return {p: dataclasses.asdict(lp) for p, lp in plan.layers.items()}


@pytest.mark.parametrize("d_model,d_ff", [(64, 128), (256, 640)])
def test_init_plan_with_algorithm_1_matches_jax(d_model, d_ff):
    from repro_torch.configs import get_smoke_config as t_smoke
    from repro_torch.configs.base import LRDConfig as TLRD
    from repro_torch.configs.base import RunConfig as TRun
    from repro_torch.configs.base import ShapeConfig as TShape
    from repro_torch.launch import steps as tsteps

    over = dict(d_model=d_model, d_ff=d_ff, head_dim=d_model // 4)
    jrun = RunConfig(model=dataclasses.replace(get_smoke_config("smollm-360m"), **over),
                     shape=ShapeConfig("t", 8, 2, "train"),
                     lrd=LRDConfig(enabled=True, min_dim=16, rank_quantize=True),
                     dist=DistConfig(fsdp=False, remat="none"))
    trun = TRun(model=dataclasses.replace(t_smoke("smollm-360m"), **over),
                shape=TShape("t", 8, 2, "train"),
                lrd=TLRD(enabled=True, min_dim=16, rank_quantize=True))
    jparams, jplan = jsteps.init_params(jrun, jax.random.PRNGKey(0))
    tparams, tplan = tsteps.init_params(trun, device="cpu")
    assert _plan(tplan) == _plan(jplan) and tplan.layers
    jshapes = jax.tree_util.tree_map(lambda a: tuple(a.shape), jparams)
    tshapes = jax.tree_util.tree_map(lambda a: tuple(a.shape), tparams)
    assert tshapes == jshapes


def test_train_cli_builds_the_jax_plan_without_no_rank_opt(capsys, tmp_path):
    """``--lrd`` without ``--no-rank-opt``: the port's CLI trains at the
    ranks (and guard decisions) of the JAX package's plan."""
    from repro_torch.launch import train

    argv = ["--smoke", "--lrd", "--lrd-min-dim", "16", "--freeze", "sequential",
            "--steps", "2", "--steps-per-epoch", "1", "--global-batch", "2",
            "--seq-len", "8", "--ckpt-dir", str(tmp_path), "--save-every", "1000"]
    state, losses = train.main(["--device", "cpu", *argv])
    assert len(losses) == 2 and all(np.isfinite(losses))
    jrun = RunConfig(model=get_smoke_config("smollm-360m"),
                     shape=ShapeConfig("t", 8, 2, "train"),
                     lrd=LRDConfig(enabled=True, min_dim=16, rank_quantize=True),
                     dist=DistConfig(fsdp=False, remat="none"))
    jparams, jplan = jsteps.init_params(jrun, jax.random.PRNGKey(0))
    assert jplan.summary() in capsys.readouterr().out
    jshapes = jax.tree_util.tree_map(lambda a: tuple(a.shape), jparams)
    tshapes = jax.tree_util.tree_map(lambda a: tuple(a.shape), state.params)
    assert tshapes == jshapes
