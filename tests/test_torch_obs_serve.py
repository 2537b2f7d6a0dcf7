"""The port's serving telemetry against the JAX package's, on the CPU: the
port's ``Scheduler`` and JAX's on ``tests/test_obs.py``'s setup (2 slots,
10 blocks of 4, so it preempts), and both ``ServeEngine``s with
speculative decoding and with the prefix cache, on the same params (made
in JAX, carried over by ``repro_torch.bridge``): the same greedy tokens,
the same lifecycle events request for request (``prompt_len``,
``fed_len``, ``resume``, ``prefix_hit_len``, ``tokens``, ``preemptions``,
...), the same ``active_slots`` / ``queued`` / pool fields of each
``serve_step``, the same registry series, no ``compile_cache`` event from
the port, and equal ``serve_summary`` counts.  Then the serve CLI with
``--obs``: a valid trace whose ``run_end`` holds ``latency_stats()``, and
on a fixed-batch family an empty one, as the reference writes."""

import json

import jax
import numpy as np
import pytest
import torch

from repro.analysis import obs_report as jreport
from repro.configs import get_smoke_config
from repro.configs.base import DistConfig, LRDConfig, RunConfig, ShapeConfig
from repro.launch import steps as jsteps
from repro.launch.mesh import make_host_mesh
from repro.obs import EventLog as JEventLog
from repro.obs import registry as jregistry
from repro.serving import ServeConfig as JServeConfig
from repro.serving import ServeEngine as JServeEngine
from repro.serving.scheduler import Scheduler as JScheduler
from repro_torch import bridge
from repro_torch.analysis import obs_report
from repro_torch.configs import get_smoke_config as t_get_smoke_config
from repro_torch.configs.base import DistConfig as TDist
from repro_torch.configs.base import LRDConfig as TLRD
from repro_torch.configs.base import RunConfig as TRun
from repro_torch.configs.base import ShapeConfig as TShape
from repro_torch.launch import serve
from repro_torch.obs import EventLog, MetricsRegistry, set_default_registry, validate_file
from repro_torch.serving import ServeConfig, ServeEngine
from repro_torch.serving.scheduler import Scheduler

torch.set_num_threads(1)

ARCH = "smollm-360m"
# per event type, the fields both schedulers must agree on (times differ)
FIELDS = {"request_queued": ("rid", "prompt_len", "max_new", "arrival"),
          "request_prefill": ("rid", "slot", "fed_len", "resume", "prefix_hit_len"),
          "request_first_token": ("rid",),
          "request_retired": ("rid", "tokens", "preemptions", "drafted_tokens",
                              "accepted_tokens", "prefix_hit_len"),
          "request_preempted": ("rid", "generated"),
          "serve_step": ("active_slots", "queued", "pool_used", "pool_free", "pool_high_water"),
          "spec_step": ("drafted", "accepted", "emitted", "acceptance_rate")}
# serve_summary's counts (the rest are latencies, and JAX's compile map)
COUNTS = ("queued", "retired", "preempt_events", "preempted_requests", "generated_tokens",
          "drafted_tokens", "accepted_tokens", "serve_steps", "prefix_lookups", "prefix_hits",
          "prefix_hit_tokens", "max_active_slots", "pool_high_water_blocks")


def _runs(max_len=32, lrd=False):
    jrun = RunConfig(model=get_smoke_config(ARCH), shape=ShapeConfig("s", max_len, 2, "decode"),
                     lrd=LRDConfig(enabled=lrd, min_dim=16, rank_quantize=False),
                     dist=DistConfig(fsdp=False, remat="none"))
    trun = TRun(model=t_get_smoke_config(ARCH), shape=TShape("s", max_len, 2, "decode"),
                lrd=TLRD(enabled=lrd, min_dim=16, rank_quantize=False),
                dist=TDist(fsdp=False, remat="none"))
    jparams, _ = jsteps.init_params(jrun, jax.random.PRNGKey(0))
    return jrun, jparams, trun, bridge.params_from_jax(jax.tree_util.tree_map(np.asarray, jparams))


def _prompts(n, vocab, lo=4, hi=12, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, int(n_tok), dtype=np.int32)
            for n_tok in rng.integers(lo, hi, n)]


def _traced(path, log_cls, registry, set_registry, serve_fn):
    """``serve_fn(log)`` with a fresh default registry; returns its result,
    the trace and the registry's snapshot."""
    reg = registry()
    prev = set_registry(reg)
    try:
        with log_cls(path) as log:
            out = serve_fn(log)
    finally:
        set_registry(prev)
    assert validate_file(path) > 0
    return out, [json.loads(line) for line in path.read_text().splitlines()], reg.snapshot()


def _structural(events):
    return [(e["type"], {k: e.get(k) for k in FIELDS[e["type"]]}) for e in events
            if e["type"] in FIELDS]


def _held_equal(jev, tev, jsnap, tsnap):
    assert not [e for e in tev if e["type"] == "compile_cache"]
    assert [e for e in jev if e["type"] == "compile_cache"]  # JAX's compile watermarks
    assert _structural(tev) == _structural(jev)
    assert all(e["ttft_s"] >= 0 for e in tev if e["type"] == "request_first_token")
    assert all(e["queue_wait_s"] >= 0 for e in tev if e["type"] == "request_prefill")
    serving = lambda snap: {k: v for k, v in snap.items()  # noqa: E731
                            if k.startswith(("serve_", "spec_"))}
    assert serving(tsnap) == serving(jsnap) and serving(tsnap)
    s, js = obs_report.serve_summary(tev), jreport.serve_summary(jev)
    assert {k: s.get(k) for k in COUNTS} == {k: js.get(k) for k in COUNTS}
    assert s["compiles"] == {} and js["compiles"]
    assert jreport.serve_summary(tev) == s  # JAX's report reads the port's trace
    return s


def test_scheduler_events_match_jax_with_preemption(tmp_path):
    """tests/test_obs.py's serve_trace on both schedulers, every request
    arriving at 0 (its 1-ms arrivals would make admission, and so the
    event order, depend on the wall clock)."""
    jrun, jparams, trun, tparams = _runs()
    prompts = _prompts(3, jrun.model.vocab_size, lo=8, hi=14, seed=7)
    kw = dict(num_slots=2, max_len=32, prefill_len=24, block_size=4, num_blocks=10)

    def drive(sched):
        for pr in prompts:
            sched.submit(pr, max_new=10)
        return sched.run(), sched.latency_stats()

    (jtoks, jstats), jev, jsnap = _traced(
        tmp_path / "jax.jsonl", JEventLog, jregistry.MetricsRegistry,
        jregistry.set_default_registry,
        lambda log: drive(JScheduler(jrun, jparams, make_host_mesh(1, 1), obs=log, **kw)))
    (toks, stats), tev, tsnap = _traced(
        tmp_path / "port.jsonl", EventLog, MetricsRegistry, set_default_registry,
        lambda log: drive(Scheduler(trun, tparams, device="cpu", obs=log, **kw)))
    assert {r: t.tolist() for r, t in toks.items()} == {r: t.tolist() for r, t in jtoks.items()}
    s = _held_equal(jev, tev, jsnap, tsnap)
    assert s["preempted_requests"] >= 1 and s["generated_tokens"] == stats["generated_tokens"]
    assert {k: stats[k] for k in ("requests", "generated_tokens", "preemptions",
                                  "preempted_requests")} == \
        {k: jstats[k] for k in ("requests", "generated_tokens", "preemptions",
                                "preempted_requests")}
    # one first token a request, across preemptions; the pool never past 10
    firsts = [e["rid"] for e in tev if e["type"] == "request_first_token"]
    assert sorted(firsts) == [0, 1, 2]
    assert max(e["pool_high_water"] for e in tev if e["type"] == "serve_step") <= 10


@pytest.mark.parametrize("feature", ["speculative", "prefix"])
def test_engine_events_match_jax(feature, tmp_path):
    """``ServeEngine(..., obs=EventLog(...))`` serves, with speculative
    decoding (``spec_step`` events and the ``spec_*`` series) or the prefix
    cache (``prefix_hit_len`` on prefills), as JAX's engine does."""
    jrun, jparams, trun, tparams = _runs(max_len=48, lrd=True)
    vocab = jrun.model.vocab_size
    if feature == "speculative":
        kw = dict(num_slots=2, max_len=48, prefill_len=16, block_size=4, speculative_k=2)
        trace = [{"prompt": p, "max_new": 9} for p in _prompts(4, vocab, seed=3)]
    else:
        kw = dict(num_slots=2, max_len=48, prefill_len=32, block_size=4, prefix_cache=True)
        trace = serve.shared_prefix_trace(5, 1e9, 12, 6, vocab, seed=2)
        for r in trace:  # all at 0: admission independent of the wall clock
            r["max_new"], r["arrival"] = 4, 0.0
    # the draft is the params themselves: every draft token is accepted
    spec = feature == "speculative"
    want, jev, jsnap = _traced(
        tmp_path / "jax.jsonl", JEventLog, jregistry.MetricsRegistry,
        jregistry.set_default_registry,
        lambda log: JServeEngine(jrun, jparams, config=JServeConfig(**kw), obs=log,
                                 draft_params=jparams if spec else None).serve(trace))
    got, tev, tsnap = _traced(
        tmp_path / "port.jsonl", EventLog, MetricsRegistry, set_default_registry,
        lambda log: ServeEngine(trun, tparams, config=ServeConfig(**kw), device="cpu", obs=log,
                                draft_params=tparams if spec else None).serve(trace))
    assert [r.tokens.tolist() for r in got] == [r.tokens.tolist() for r in want]
    s = _held_equal(jev, tev, jsnap, tsnap)
    if spec:
        assert s["drafted_tokens"] > 0 and s["accepted_tokens"] == s["drafted_tokens"]
        assert tsnap["spec_acceptance_rate"]["series"][""] == 1.0
    else:
        assert s["prefix_hits"] > 0


def test_serve_cli_writes_a_trace(tmp_path, capsys):
    argv = ["--smoke", "--device", "cpu", "--lrd", "--slots", "2", "--requests", "4",
            "--prompt-len", "8", "--max-new", "4", "--block-size", "4", "--num-blocks", "6",
            "--obs", "--obs-dir", str(tmp_path / "obs")]
    engine, outs = serve.main(argv)
    events = obs_report.load_events(tmp_path / "obs" / "events.jsonl")
    kinds = [e["type"] for e in events]
    assert kinds[0] == "run_start" and kinds[-1] == "run_end"
    assert events[0]["kind"] == "serve" and events[0]["requests"] == 4
    stats = engine.scheduler.latency_stats()
    assert {k: events[-1][k] for k in stats} == stats
    assert kinds.count("serve_step") == engine.scheduler.forward_stats["decode"]
    for t in ("request_queued", "request_prefill", "request_first_token", "request_retired"):
        assert sorted(e["rid"] for e in events if e["type"] == t
                      and not e.get("resume")) == [0, 1, 2, 3], t
    s = obs_report.serve_summary(events)
    assert s["generated_tokens"] == stats["generated_tokens"] == sum(len(o) for o in outs)
    assert capsys.readouterr().out.count("{") == 0  # the text mirror prints no event
    # --log-format jsonl mirrors every event written to the file to the
    # console, run_start and run_end excepted
    serve.main([*argv[:-1], str(tmp_path / "obs2"), "--log-format", "jsonl"])
    shown = [line for line in capsys.readouterr().out.splitlines() if line.startswith("{")]
    assert shown == (tmp_path / "obs2" / "events.jsonl").read_text().splitlines()[1:-1]
    assert len(shown) == len(events) - 2


def test_fixed_batch_serve_writes_an_empty_trace(tmp_path):
    """The SSM family serves on the fixed-batch path: the reference opens
    its log there and emits nothing into it."""
    serve.main(["--arch", "xlstm-350m", "--smoke", "--device", "cpu", "--lrd", "--slots", "2",
                "--prompt-len", "6", "--max-new", "2", "--obs", "--obs-dir",
                str(tmp_path / "obs")])
    assert (tmp_path / "obs" / "events.jsonl").read_text() == ""
