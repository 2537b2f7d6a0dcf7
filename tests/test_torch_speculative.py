"""Self-speculative decoding in the port against the JAX package, on the
same params (made in JAX, carried over by ``repro_torch.bridge``): the same
draft rank map, truncated drafts whose products ``u @ v`` agree within
1e-4 (the draft the engines serve is JAX's, carried over, since the two
LAPACKs flip singular-vector signs), the same acceptance rule, and the same
greedy tokens and draft counts through both ``ServeEngine``s for k in
{1, 2, 4} with the draft = params and with a truncated draft.  47-token
requests retire mid-chunk at every k."""

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config
from repro.configs.base import DistConfig, LRDConfig, RunConfig, ShapeConfig
from repro.core.decompose import iter_factor_groups as j_groups
from repro.launch import steps as jsteps
from repro.serving import ServeConfig as JServeConfig
from repro.serving import ServeEngine as JServeEngine
from repro.serving import speculative as jspec
from repro_torch import bridge
from repro_torch.configs import get_smoke_config as t_get_smoke_config
from repro_torch.configs.base import DistConfig as TDist
from repro_torch.configs.base import LRDConfig as TLRD
from repro_torch.configs.base import RunConfig as TRun
from repro_torch.configs.base import ShapeConfig as TShape
from repro_torch.core.decompose import iter_factor_groups as t_groups
from repro_torch.launch import serve as tserve
from repro_torch.serving import ServeConfig, ServeEngine
from repro_torch.serving import speculative as tspec

torch.set_num_threads(1)

ARCH = "smollm-360m"
WINDOW = dict(num_slots=2, max_len=64, prefill_len=16, block_size=8)
# the product of a truncated factor pair, relative to its max: both sides
# take an r x r SVD in float32, whose rounding differs by a few ulps
PRODUCT_RTOL = 1e-4


@pytest.fixture(scope="module")
def models():
    jrun = RunConfig(model=get_smoke_config(ARCH), shape=ShapeConfig("s", 64, 2, "decode"),
                     lrd=LRDConfig(enabled=True, min_dim=16, rank_quantize=False),
                     dist=DistConfig(fsdp=False, remat="none"))
    trun = TRun(model=t_get_smoke_config(ARCH), shape=TShape("s", 64, 2, "decode"),
                lrd=TLRD(enabled=True, min_dim=16, rank_quantize=False),
                dist=TDist(fsdp=False, remat="none"))
    jparams, _ = jsteps.init_params(jrun, jax.random.PRNGKey(7))
    tparams = bridge.params_from_jax(jax.tree_util.tree_map(np.asarray, jparams))
    rng = np.random.default_rng(8)
    trace = [{"prompt": rng.integers(0, jrun.model.vocab_size, int(rng.integers(4, 16)),
                                     dtype=np.int32), "max_new": 47} for _ in range(3)]
    jdraft, jreport = jspec.make_draft_params(jparams, jspec.draft_rank_map(jparams, rank=4))
    plain = JServeEngine(jrun, jparams, config=JServeConfig(**WINDOW)).serve(trace)
    return dict(jrun=jrun, trun=trun, jparams=jparams, tparams=tparams, trace=trace,
                jdraft=jdraft, jreport=jreport, plain=[r.tokens.tolist() for r in plain])


@pytest.mark.parametrize("kw", [dict(), dict(fraction=0.25), dict(rank=5)])
def test_draft_rank_map_matches_jax(models, kw):
    assert tspec.draft_rank_map(models["tparams"], **kw) == \
        jspec.draft_rank_map(models["jparams"], **kw)


def test_draft_products_match_jax(models):
    rank_map = jspec.draft_rank_map(models["jparams"], rank=4)
    tdraft, treport = tspec.make_draft_params(models["tparams"], rank_map)
    assert treport.layers == models["jreport"].layers
    assert treport.truncated == models["jreport"].truncated > 0
    jg = dict(j_groups(models["jdraft"]))
    for path, group in t_groups(tdraft):
        want = np.einsum("...cr,...rs->...cs", np.asarray(jg[path]["u"], np.float64),
                         np.asarray(jg[path]["v"], np.float64))
        got = torch.matmul(group["u"].double(), group["v"].double()).numpy()
        assert np.abs(got - want).max() <= PRODUCT_RTOL * np.abs(want).max(), path
    # a group at or below its target is the full model's own tensor
    _, shared = tspec.make_draft_params(models["tparams"], {})
    assert shared.truncated == 0
    same, _ = tspec.make_draft_params(models["tparams"], {})
    assert all(a["u"] is b["u"] for (_, a), (_, b) in zip(t_groups(same),
                                                           t_groups(models["tparams"])))


def test_accept_lengths_match_jax():
    rng = np.random.default_rng(9)
    for k in (0, 1, 2, 4):
        chunk = rng.integers(0, 3, (16, k + 1))
        verify = rng.integers(0, 3, (16, k + 1))
        np.testing.assert_array_equal(tspec.accept_lengths(chunk, verify),
                                      jspec.accept_lengths(chunk, verify))


@pytest.mark.parametrize("k,draft", [(1, "params"), (2, "params"), (4, "params"),
                                     (2, "truncated"), (4, "truncated")])
def test_spec_tokens_match_jax_engine(models, k, draft):
    jdraft = models["jparams"] if draft == "params" else models["jdraft"]
    tdraft = bridge.params_from_jax(jax.tree_util.tree_map(np.asarray, jdraft))
    cfg = dict(WINDOW, speculative_k=k)
    jeng = JServeEngine(models["jrun"], models["jparams"], config=JServeConfig(**cfg),
                        draft_params=jdraft)
    want = jeng.serve(models["trace"])
    engine = ServeEngine(models["trun"], models["tparams"], config=ServeConfig(**cfg),
                         device="cpu", draft_params=tdraft)
    got = engine.serve(models["trace"])
    toks = [r.tokens.tolist() for r in got]
    assert toks == [r.tokens.tolist() for r in want] == models["plain"]
    sched = engine.scheduler
    assert sched.spec_stats == jeng.scheduler.spec_stats
    assert [(r.drafted_tokens, r.accepted_tokens) for r in got] == \
        [(r.drafted_tokens, r.accepted_tokens) for r in want]
    if draft == "params":
        assert sched.acceptance_rate() == 1.0
    # the plain decode step never runs while speculating; k draft forwards
    # and one verify forward a speculative step
    fwd = sched.forward_stats
    assert fwd["decode"] == 0 and fwd["nonfinite"] == 0
    assert fwd["verify"] == sched.spec_stats["spec_steps"] and fwd["draft"] == k * fwd["verify"]


def test_spec_eos_mid_chunk(models):
    """A request whose eos falls inside an accepted chunk retires at that
    token, exactly as plain decode does."""
    trace = [dict(r, eos_id=int(p[3])) for r, p in zip(models["trace"], models["plain"])]
    engine = ServeEngine(models["trun"], models["tparams"], device="cpu",
                         config=ServeConfig(**WINDOW, speculative_k=4))
    got = engine.serve(trace)
    assert [r.tokens.tolist() for r in got] == [p[:p.index(p[3]) + 1]
                                                for p in models["plain"]]


def test_engine_derives_the_draft_lazily(models):
    engine = ServeEngine(models["trun"], models["tparams"], device="cpu",
                         config=ServeConfig(**WINDOW, speculative_k=2, spec_rank=4))
    assert engine.draft_report is None
    got = engine.serve(models["trace"][:1])
    assert engine.draft_report.layers == models["jreport"].layers
    assert got[0].tokens.tolist() == models["plain"][0]


def test_serve_cli_speculative(capsys):
    engine, outs = tserve.main(["--smoke", "--device", "cpu", "--lrd", "--requests", "3",
                                "--slots", "2", "--prompt-len", "8", "--max-new", "5",
                                "--spec-k", "2"])
    out = capsys.readouterr().out
    assert "draft: 7 factor groups" in out and "speculative: k=2" in out
    assert [len(o) for o in outs] == [5, 5, 5]
    assert engine.scheduler.forward_stats["decode"] == 0
