"""The port's autotuner (``repro_torch.kernels.autotune``) case for case
against ``tests/test_autotune.py``: table persistence and keying (the
reference's ``bucket_m``), no row per batch size, stale device kinds, the
demotion of a timing a plain version took (reason ``platform``), the
dispatcher's consult (a bucketed hit the wrapper cannot take at M keeps the
hand-set choice), a JAX table refused, the CLI run twice, and one
``autotune_lookups`` count a key.  Nothing here reads a wall clock: the CPU
runs only the plain versions, so nothing is timed."""

import json

import jax.numpy as jnp
import pytest
import torch

from repro.kernels import autotune as jautotune
from repro_torch.kernels import autotune, ops
from repro_torch.kernels.autotune import Choice, TuneEntry, TuningTable
from repro_torch.obs import MetricsRegistry, set_default_registry

torch.set_num_threads(1)

BF16 = torch.bfloat16


def _entry(choice=Choice("large"), source="measured", kind=None, **kw):
    return TuneEntry(choice=choice, us=12.5, source=source,
                     device_kind=kind or autotune.device_kind(), **kw)


@pytest.fixture
def no_active_table():
    """Isolate the process-wide active table around each test."""
    prev = autotune.set_table(None)
    yield
    autotune.set_table(prev)


@pytest.fixture
def registry():
    reg = MetricsRegistry()
    prev = set_default_registry(reg)
    yield reg
    set_default_registry(prev)


# --------------------------------------------------------------------------
# persistence + keying
# --------------------------------------------------------------------------

def test_table_disk_roundtrip(tmp_path):
    t = TuningTable()
    t.put("lowrank_fwd", 256, 512, 64, 256, BF16, _entry(Choice("decode", (4, 128, 1, 8, 16))))
    t.put("lowrank_dx", 512, 1024, 128, 512, BF16,
          _entry(Choice("dx", (4, 4)), source="analytic", fallback_reason="platform"),
          freeze_phase=1)
    t.put("flash", 2016, 15, 64, 2016, BF16, _entry(Choice("flash", (120,)), hand_us=13.0,
                                                    predicted_us=9.5))
    path = t.save(str(tmp_path / "tune.json"))
    t2 = TuningTable.load(path)
    assert t2.entries == t.entries
    e = t2.lookup("lowrank_dx", 512, 1024, 128, 512, BF16, freeze_phase=1)
    assert e is not None and e.fallback_reason == "platform" and e.choice.plan == (4, 4)


@pytest.mark.parametrize("m", [1, 7, 8, 9, 100, 128, 129, 257, 2016, 2048, 2049, 70000])
def test_bucket_m_is_the_references(m):
    assert autotune.bucket_m(m) == jautotune.bucket_m(m)


def test_shape_bucket_keying():
    t = TuningTable()
    t.put("lowrank_fwd", 300, 512, 64, 256, BF16, _entry())
    # every m in the same power-of-two bucket (256, 512] hits the same row
    for m in (257, 300, 400, 512):
        assert t.lookup("lowrank_fwd", m, 512, 64, 256, BF16) is not None
    assert t.lookup("lowrank_fwd", 256, 512, 64, 256, BF16) is None
    assert t.lookup("lowrank_fwd", 513, 512, 64, 256, BF16) is None
    # weight geometry keys exactly: a different c is a different row
    assert t.lookup("lowrank_fwd", 300, 1024, 64, 256, BF16) is None
    # as does the dtype and the freeze phase
    assert t.lookup("lowrank_fwd", 300, 512, 64, 256, torch.float32) is None
    assert t.lookup("lowrank_fwd", 300, 512, 64, 256, BF16, freeze_phase=0) is None
    assert len(t) == 1


def test_search_does_not_mint_rows_per_batch_size(no_active_table):
    # distinct m values inside one bucket -> ONE table row, not three
    table = autotune.search([(260, 512, 64, 256), (300, 512, 64, 256), (500, 512, 64, 256)],
                            ops_list=("lowrank_fwd",), measure=False)
    assert len(table) == 1


def test_stale_device_kind_is_a_miss():
    t = TuningTable()
    kind = autotune.device_kind()
    t.put("lowrank_fwd", 256, 512, 64, 256, BF16, _entry())
    # another card's key never matches this host's lookups
    t.put("lowrank_fwd", 256, 512, 64, 256, BF16, _entry(kind="NVIDIA A100-SXM4-80GB"))
    assert t.lookup("lowrank_fwd", 256, 512, 64, 256, BF16,
                    kind="NVIDIA A100-SXM4-80GB") is not None
    got = t.lookup("lowrank_fwd", 256, 512, 64, 256, BF16, kind=kind)
    assert got is not None and got.device_kind == kind
    # a corrupted row (key kind != entry kind) is a miss, not served
    key = autotune._key("lowrank_fwd", 256, 512, 64, 256, BF16, kind, None)
    t.entries[key] = _entry(kind="NVIDIA A100-SXM4-80GB")
    assert t.lookup("lowrank_fwd", 256, 512, 64, 256, BF16, kind=kind) is None
    assert t.stats == {"hit": 2, "miss": 0, "stale": 1}


def test_jax_table_refused(tmp_path):
    """A table the JAX package wrote keys block triples of its Pallas
    kernels: loading it names why it is refused."""
    jt = jautotune.TuningTable()
    jt.put("lowrank_fwd", 256, 512, 64, 256, jnp.bfloat16,
           jautotune.TuneEntry(128, 256, 128, us=1.0, source="measured", device_kind="cpu"))
    path = jt.save(str(tmp_path / "jax.json"))
    with pytest.raises(ValueError, match="JAX package"):
        TuningTable.load(path)
    with pytest.raises(ValueError, match="JAX package"):
        autotune.load_table(path)


# --------------------------------------------------------------------------
# search: a plain version's timing is demoted with its reason
# --------------------------------------------------------------------------

@pytest.mark.parametrize("op", autotune.OPS)
def test_no_measured_entry_from_plain_timing(no_active_table, op):
    """On the CPU the dispatcher runs the plain versions: forcing a
    measurement records the analytic winner with reason ``platform``."""
    shape = (16, 15, 16, 16) if op == "flash" else (16, 64, 8, 32)
    table = autotune.search([shape], ops_list=(op,), measure=True, iters=1)
    e = table.lookup(op, *shape, BF16)
    assert e is not None
    assert e.source == "analytic" and e.fallback_reason == "platform"
    assert e.us == e.predicted_us > 0 and e.hand_us == 0.0


def test_search_analytic_ranks_by_the_model(no_active_table):
    from repro_torch.analysis import roofline

    m, c, r, s = 8, 960, 240, 960
    table = autotune.search([(m, c, r, s)], ops_list=("lowrank_fwd",), measure=False)
    e = table.lookup("lowrank_fwd", m, c, r, s, BF16)
    cands = roofline.prune_choices("lowrank_fwd", m, c, r, s,
                                   autotune.candidates("lowrank_fwd", m, c, r, s, 132))
    assert e.source == "analytic" and e.choice == cands[0]
    assert e.us == pytest.approx(roofline.choice_time("lowrank_fwd", m, c, r, s, e.choice) * 1e6)
    # the second search over the same key is a cache hit: nothing added
    n, hits = len(table), table.stats["hit"]
    autotune.search([(m, c, r, s)], ops_list=("lowrank_fwd",), measure=False)
    assert len(table) == n and table.stats["hit"] == hits + 1


def test_decode_plan_shared_across_buckets(no_active_table):
    """K1's decode plan is chosen once a geometry: every bucket that takes
    the decode design takes the same plan, so a row's bits do not move
    with M."""
    table = autotune.search([(m, 960, 240, 960) for m in (8, 32, 128, 256)],
                            ops_list=("lowrank_fwd",), measure=False)
    plans = {e.choice.plan for e in table.entries.values() if e.choice.design == "decode"}
    assert len(plans) == 1


# --------------------------------------------------------------------------
# the dispatcher's consult
# --------------------------------------------------------------------------

def test_tuned_consult(no_active_table):
    dt = "bfloat16"
    # no active table -> the hand-set choice (None)
    assert ops._tuned("lowrank_du", 2048, 960, 240, 960, dt, None) is None
    t = TuningTable()
    autotune.set_table(t)
    # miss -> the hand-set choice
    assert ops._tuned("lowrank_du", 2048, 960, 240, 960, dt, None) is None
    t.put("lowrank_du", 2048, 960, 240, 960, BF16, _entry(Choice("split", (16,))))
    assert ops._tuned("lowrank_du", 2048, 960, 240, 960, dt, None) == Choice("split", (16,))
    # a bucketed hit the wrapper cannot take at this M (16 ways over 9
    # boxes of 128 rows) keeps the hand-set choice
    assert ops._tuned("lowrank_du", 1100, 960, 240, 960, dt, None) is None
    # K2's plan: groups past the call's row blocks are not taken either
    t.put("lowrank_dx", 2048, 960, 240, 960, BF16, _entry(Choice("dx", (4, 16))))
    assert ops._tuned("lowrank_dx", 2048, 960, 240, 960, dt, None) == Choice("dx", (4, 16))
    assert ops._tuned("lowrank_dx", 1100, 960, 240, 960, dt, None) is None
    # the freeze phase keys: phase 0 is another row
    assert ops._tuned("lowrank_du", 2048, 960, 240, 960, dt, 0) is None


@pytest.mark.parametrize("m,choice,ok", [
    (8, Choice("decode", (4, 240, 1, 8, 16)), True), (8, Choice("large"), True),
    (128, Choice("split", (1,)), True), (128, Choice("split", (2,)), False),
    (2048, Choice("split", (16,)), True), (2048, Choice("split", (17,)), False),
    (256, Choice("dx", (8, 2)), True), (256, Choice("dx", (8, 3)), False),
    (256, Choice("dx", (9, 1)), False), (2016, Choice("flash", (120,)), True)])
def test_takes(m, choice, ok):
    assert autotune.takes(m, 960, choice) is ok


def test_lookups_counted_once_a_key(no_active_table, registry):
    """On meta tensors the policy's kernel path resolves each call key
    once: three calls at one shape and two at another are two lookups."""
    autotune.set_table(TuningTable())
    meta = torch.device("meta")
    u = torch.empty((960, 240), dtype=BF16, device=meta)
    v = torch.empty((240, 960), dtype=BF16, device=meta)
    for m in (8, 8, 8, 24, 24):
        x = torch.empty((m, 960), dtype=BF16, device=meta)
        y = ops.lowrank_apply(x, u, v, use_kernel=True, autotune=True)
        assert y.shape == (m, 960) and y.device == meta
    counter = registry.counter("autotune_lookups")
    assert counter.value(op="lowrank_fwd", result="miss") == 2
    # without autotune nothing is looked up
    ops.lowrank_apply(torch.empty((40, 960), dtype=BF16, device=meta), u, v,
                      use_kernel=True)
    assert counter.value(op="lowrank_fwd", result="miss") == 2
    # a put drops the cached resolutions: the next call looks up again (a hit)
    autotune.get_table().put("lowrank_fwd", 8, 960, 240, 960, BF16, _entry())
    ops.lowrank_apply(torch.empty((8, 960), dtype=BF16, device=meta), u, v,
                      use_kernel=True, autotune=True)
    assert counter.value(op="lowrank_fwd", result="hit") == 1


def test_kernel_available_needs_the_card():
    assert ops.kernel_available() is (torch.cuda.is_available()
                                      and torch.cuda.get_device_capability() == (9, 0))


def test_policy_loads_the_table_once(no_active_table, tmp_path):
    from repro_torch.configs import get_smoke_config
    from repro_torch.configs.base import LRDConfig, RunConfig, ShapeConfig
    from repro_torch.launch import steps

    path = tmp_path / "t.json"
    TuningTable({autotune._key("lowrank_fwd", 8, 64, 8, 64, BF16, "cpu", None):
                 _entry(kind="cpu")}).save(str(path))
    run = RunConfig(model=get_smoke_config("smollm-360m"), shape=ShapeConfig("s", 8, 1, "decode"),
                    lrd=LRDConfig(enabled=True, pallas_autotune=True,
                                  pallas_autotune_table=str(path)))
    pol = steps.kernel_policy(run)
    assert pol.autotune and len(autotune.get_table()) == 1
    mine = TuningTable()
    autotune.set_table(mine)
    steps.kernel_policy(run)  # an active table is never replaced
    assert autotune.get_table() is mine
    off = RunConfig(model=run.model, shape=run.shape, lrd=LRDConfig(enabled=True))
    assert not steps.kernel_policy(off).autotune


# --------------------------------------------------------------------------
# CLI: run 1 fills the table, run 2 is all cache hits
# --------------------------------------------------------------------------

def test_cli_run_twice(no_active_table, tmp_path, capsys):
    path = tmp_path / "tune.json"
    argv = ["--table", str(path), "--shapes", "8x64x8x64", "2048x64x8x64",
            "--ops", "lowrank_fwd", "lowrank_dx", "--freeze-phase", "-1", "0"]
    t1 = autotune.main(argv)
    out1 = capsys.readouterr().out
    assert len(t1) == 2 * 2 * 2 and out1.count("tuned: ") == 4
    # no card: the CLI measures nothing and records the analytic winners
    assert {(e.source, e.fallback_reason) for e in t1.entries.values()} == {("analytic", "")}
    autotune.set_table(None)
    t2 = autotune.main(argv)
    out2 = capsys.readouterr().out
    assert out2.count("cache-hit: ") == 4 and "tuned: " not in out2
    assert t2.entries == t1.entries and t2.stats["miss"] == 0
    assert json.loads(path.read_text())["package"] == "repro_torch"


def test_shared_plan_minimises_the_buckets_total():
    """The decode plan is chosen once for all buckets: a plan that wins at
    M 8 but loses more at M 256 (where the large design is slower still)
    is not taken; at M 2048 the large design sets the bucket's time, so
    that bucket does not weigh on the choice."""
    c, r, s = 2560, 349, 960
    plans = [ch.plan for ch in autotune.candidates("lowrank_fwd", 8, c, r, s, 132)
             if ch.design == "decode"]
    a, b = plans[0], plans[1]
    us = {(8, a): 10.0, (8, b): 11.0, (256, a): 50.0, (256, b): 40.0,
          (2048, a): 1.0e4, (2048, b): 2.0e4}

    def timed(op, shape, ch):
        m = shape[0]
        if ch.design == "large":
            return {8: 1e9, 256: 45.0, 2048: 60.0}[m], []
        return us.get((m, ch.plan), 1e6), []

    assert autotune._choose_plan("lowrank_fwd", [8, 256, 2048], c, r, s, 132, timed) == b
    us[(256, b)] = 46.0  # the large design (45) now takes M 256 under either plan
    assert autotune._choose_plan("lowrank_fwd", [8, 256, 2048], c, r, s, 132, timed) == a
