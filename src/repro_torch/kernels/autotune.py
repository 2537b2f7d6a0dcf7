"""Design and plan autotuner for the hand-written CUDA kernels — the
counterpart of ``repro/kernels/autotune.py``.

The reference tunes the Pallas kernels' block triples.  The port's kernels
take no blocks: each has one knob, set by hand from ``chip_smoke.py``'s
design and plan sweeps on one card, and this module tunes it per shape:

* K1 (``lowrank_fwd``) and K5 (``lowrank_ffn``): the design, ``decode`` or
  ``large`` (hand-set: ``lowrank_matmul.large_m`` / ``lowrank_ffn.LARGE_M``),
  and for the decode design its plan ``(cs, kc, per, w1, w2)``
  (``decode_plan``).  The plan fixes the order in which a row's products
  are summed, so it is chosen once per geometry (C, r, S and the branches)
  and shared by every M bucket: a row has the same bits at every M;
* K2 (``lowrank_dx``): phase 2's ``(g, groups)`` (``dx_plan``);
* K3 / K4 (``lowrank_du`` / ``lowrank_dv``): the ways the sum over M is
  split (``split_plan``);
* K8 (``flash``): the persistent grid's CTAs (``flash_grid``).

**Candidates** are the hand-set choice and its neighbours, pruned and
ordered by ``analysis.roofline.prune_choices`` (shared memory against the
block limit, then predicted time).  **Measurement** times the best few and
the hand-set one through the dispatcher (``kernels.ops``) with
:func:`time_fn`, the timer ``chip_smoke.py`` times every kernel row with.
A call the dispatcher sent to a plain version (CPU tensors) is captured
with ``ops.capture_fallbacks`` and never recorded as ``measured``: the
entry falls back to the analytic winner with the reason.  **The table**
keys winners as the reference does, by ``(op, M bucket, C, r, S, dtype,
device_kind, freeze_phase)``, with ``device_kind`` the card's
``torch.cuda.get_device_name()``; an entry of another device kind is
stale, and a table the JAX package wrote is refused on load.

``kernels.ops`` consults the active table when the ``KernelPolicy`` sets
``autotune`` (``lrd.pallas_autotune``); a miss, or a hit the wrapper
cannot take at the call's M, keeps the hand-set choice.

    python -m repro_torch.kernels.autotune --table runs/tune.json \\
        --shapes 8x960x240x960 2048x960x240x960 --ops lowrank_fwd lowrank_dx

A second run against the same table reports ``cache-hit`` per key and
measures nothing.
"""

from __future__ import annotations

import dataclasses
import json
import math
import pathlib
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch.analysis import roofline
from repro_torch.kernels import flash_attention as k8
from repro_torch.kernels import lowrank_bwd as kb
from repro_torch.kernels import lowrank_ffn as k5
from repro_torch.kernels import lowrank_matmul as k1
from repro_torch.obs import registry as obs_registry

__all__ = ["OPS", "Choice", "TuneEntry", "TuningTable", "time_fn", "device_kind", "bucket_m",
           "hand_choice", "candidates", "takes", "search", "get_table", "set_table",
           "load_table"]

OPS = ("lowrank_fwd", "lowrank_dx", "lowrank_du", "lowrank_dv", "lowrank_ffn", "flash")
_MIN_BUCKET = 8
# the package a table names; the reference's tables name none
PACKAGE = "repro_torch"
# device clock cycles the timer holds the card after each flush (about 0.5
# ms at the H100's 1.98 GHz boost clock)
HOLD_CYCLES = 1_000_000
# the fewest rows at which the large-M design is a candidate: one of its
# 64-row blocks
LARGE_MIN_M = 64


def time_fn(fn, iters: int, flush: torch.Tensor) -> float:
    """Median device time of ``fn()`` over ``iters`` launches, each after
    an L2 flush (the serving path reads every layer's factors cold).  A
    sleep kernel after the flush gives the host time to enqueue all of
    ``fn`` before the start event is reached, however slow the host, so
    host overhead stays out of the reading."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        flush.zero_()
        torch.cuda._sleep(HOLD_CYCLES)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    times.sort()
    return times[len(times) // 2]


def device_kind() -> str:
    """The card's name (``torch.cuda.get_device_name()``), or ``cpu``."""
    return torch.cuda.get_device_name() if torch.cuda.is_available() else "cpu"


def bucket_m(m: int) -> int:
    """The batch/token dim bucketed to its next power of two (>= 8): weight
    geometry keys exactly, M does not, so every decode batch size does not
    mint a row."""
    b = _MIN_BUCKET
    while b < m:
        b *= 2
    return b


def _dtype_name(dtype) -> str:
    return str(dtype).replace("torch.", "")


@dataclasses.dataclass(frozen=True)
class Choice:
    """One kernel's knob: ``design`` ``decode`` (with ``plan`` (cs, kc, per,
    w1, w2)) or ``large`` for K1/K5; ``dx`` (plan (g, groups)) for K2;
    ``split`` (plan (splits,)) for K3/K4; ``flash`` (plan (grid,)) for K8."""

    design: str
    plan: Tuple[int, ...] = ()

    def kwargs(self) -> Dict:
        """The wrapper keywords that launch this choice."""
        if self.design == "large":
            return {"large": True}
        if self.design == "decode":
            return {"large": False, "plan": self.plan}
        if self.design == "dx":
            return {"plan": self.plan}
        if self.design == "split":
            return {"splits": self.plan[0]}
        return {"grid": self.plan[0]}

    def text(self) -> str:
        return self.design + (str(tuple(self.plan)) if self.plan else "")


@dataclasses.dataclass(frozen=True)
class TuneEntry:
    choice: Choice
    us: float  # measured (or predicted, per source) microseconds
    source: str  # "measured" | "analytic"
    device_kind: str
    fallback_reason: str = ""  # non-empty iff a measured run was demoted
    hand_us: float = 0.0  # the hand-set choice's time, measured beside it
    predicted_us: float = 0.0  # the winner's time by roofline.choice_time


def _key(op: str, m: int, c: int, r: int, s: int, dtype, kind: str,
         freeze_phase: Optional[int]) -> Tuple:
    fp = -1 if freeze_phase is None else int(freeze_phase)
    return (op, bucket_m(m), int(c), int(r), int(s), _dtype_name(dtype), kind, fp)


class TuningTable:
    """Persistent map from tuned-op keys to winning choices."""

    VERSION = 1

    def __init__(self, entries: Optional[Dict[Tuple, TuneEntry]] = None,
                 path: Optional[str] = None):
        self.entries: Dict[Tuple, TuneEntry] = dict(entries or {})
        self.path = path
        # per-table lookup outcomes; the same counts feed the
        # ``autotune_lookups{op, result}`` counter of the default registry
        self.stats = {"hit": 0, "miss": 0, "stale": 0}
        # bumped by every put: the dispatcher's resolutions of an older
        # generation are dropped
        self.generation = 0

    def __len__(self) -> int:
        return len(self.entries)

    def lookup(self, op: str, m: int, c: int, r: int, s: int, dtype,
               *, freeze_phase: Optional[int] = None,
               kind: Optional[str] = None) -> Optional[TuneEntry]:
        """The winning entry for this op and shape bucket, or None.  An
        entry recorded under another ``device_kind`` is stale: a table tuned
        on one card does not steer launches on another."""
        kind = kind or device_kind()
        e = self.entries.get(_key(op, m, c, r, s, dtype, kind, freeze_phase))
        result = "hit" if e is not None else "miss"
        if e is not None and e.device_kind != kind:
            e, result = None, "stale"
        self.stats[result] += 1
        obs_registry.default_registry().counter(
            "autotune_lookups", "TuningTable consults at dispatch/search time").inc(
                op=op, result=result)
        return e

    def put(self, op: str, m: int, c: int, r: int, s: int, dtype,
            entry: TuneEntry, *, freeze_phase: Optional[int] = None) -> None:
        self.entries[_key(op, m, c, r, s, dtype, entry.device_kind, freeze_phase)] = entry
        self.generation += 1

    def shared_plan(self, op: str, c: int, r: int, s: int, dtype, kind: str) -> Optional[Tuple]:
        """The decode plan an entry of this geometry already chose (K1/K5:
        one plan at every M bucket), or None."""
        for (o, _, c2, r2, s2, dt, k, _), e in self.entries.items():
            if ((o, c2, r2, s2, dt, k) == (op, c, r, s, _dtype_name(dtype), kind)
                    and e.choice.design == "decode"):
                return e.choice.plan
        return None

    # -- persistence --------------------------------------------------------

    def save(self, path: Optional[str] = None) -> str:
        path = path or self.path
        if not path:
            raise ValueError("TuningTable.save needs a path")
        rows = []
        for (op, mb, c, r, s, dt, kind, fp), e in sorted(self.entries.items()):
            row = dataclasses.asdict(e)
            row["choice"] = {"design": e.choice.design, "plan": list(e.choice.plan)}
            rows.append({"op": op, "m_bucket": mb, "c": c, "r": r, "s": s, "dtype": dt,
                         "device_kind": kind, "freeze_phase": fp, **row})
        p = pathlib.Path(path)
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_text(json.dumps({"version": self.VERSION, "package": PACKAGE,
                                 "entries": rows}, indent=1))
        self.path = str(p)
        return str(p)

    @classmethod
    def load(cls, path: str) -> "TuningTable":
        data = json.loads(pathlib.Path(path).read_text())
        if data.get("package") != PACKAGE or any("block_m" in row
                                                 for row in data.get("entries", ())):
            raise ValueError(
                f"{path}: a tuning table of the JAX package (block triples of its "
                f"Pallas kernels), not of {PACKAGE}: the CUDA kernels take a design or "
                f"a plan, not blocks; tune them with python -m "
                f"repro_torch.kernels.autotune --table <another path>")
        if data.get("version") != cls.VERSION:
            raise ValueError(f"{path}: table version {data.get('version')}, want "
                             f"{cls.VERSION}")
        entries: Dict[Tuple, TuneEntry] = {}
        for row in data["entries"]:
            key = (row["op"], row["m_bucket"], row["c"], row["r"], row["s"],
                   row["dtype"], row["device_kind"], row["freeze_phase"])
            ch = row["choice"]
            entries[key] = TuneEntry(
                choice=Choice(ch["design"], tuple(ch["plan"])), us=row["us"],
                source=row["source"], device_kind=row["device_kind"],
                fallback_reason=row.get("fallback_reason", ""),
                hand_us=row.get("hand_us", 0.0), predicted_us=row.get("predicted_us", 0.0))
        return cls(entries, path=path)


# Process-wide active table, consulted by kernels.ops.
_ACTIVE: Optional[TuningTable] = None


def get_table() -> Optional[TuningTable]:
    return _ACTIVE


def set_table(table: Optional[TuningTable]) -> Optional[TuningTable]:
    global _ACTIVE
    prev, _ACTIVE = _ACTIVE, table
    return prev


def load_table(path: str) -> TuningTable:
    """Load ``path`` (an empty table if absent) and make it the active one."""
    p = pathlib.Path(path)
    table = TuningTable.load(str(p)) if p.exists() else TuningTable(path=str(p))
    set_table(table)
    return table


# --------------------------------------------------------------------------
# choices: the hand-set one, its neighbours, and what a wrapper takes
# --------------------------------------------------------------------------

def _sms() -> int:
    if torch.cuda.is_available():
        return k1.sm_count(torch.cuda.current_device())
    return roofline.H100_SPECS.sms


def hand_choice(op: str, m: int, c: int, r: int, s: int, sms: int) -> Choice:
    """What the wrapper takes at (M, C, r, S) untuned (for ``flash``: M is
    Sq, C the heads of one batch row, r the head dim, S is Sk)."""
    if op in ("lowrank_fwd", "lowrank_ffn"):
        nb = 2 if op == "lowrank_ffn" else 1
        large = m >= (k1.large_m(c, r) if nb == 1 else k5.LARGE_M)
        return Choice("large") if large else Choice("decode", k1.decode_plan(c, r, s, sms, nb))
    if op == "lowrank_dx":
        return Choice("dx", kb.dx_plan(m, c, sms))
    if op == "lowrank_du":
        return Choice("split", (kb.split_plan(m, c, r, sms),))
    if op == "lowrank_dv":
        return Choice("split", (kb.split_plan(m, r, s, sms),))
    if op == "flash":
        return Choice("flash", (k8.flash_grid(k8.flash_unit_count(1, m, c), sms),))
    raise ValueError(f"unknown op {op!r}")


def _decode_plans(c: int, r: int, s: int, sms: int, nb: int) -> List[Tuple]:
    """``decode_plan`` and its neighbours: the rank tile halved and
    doubled, the column tile at 8, and clusters of 2 and 8 CTAs at the
    plan's widths (``chip_smoke.py``'s plans sweep)."""
    cs0, kc0, per0, w10, w20 = k1.decode_plan(c, r, s, sms, nb)
    plans = {(cs0, kc0, per0, w1, w2) for w2 in (8, w20)
             for w1 in (max(8, w10 // 16 * 8), w10, min(k1.W1_MAX, 2 * w10))}
    for cs in (2, 8):
        kc = -(-c // cs // 16) * 16
        if 16 <= kc <= k1.KC_MAX:
            plans.add((-(-c // kc), kc, 1, w10, w20))
    return sorted(plans)


def candidates(op: str, m: int, c: int, r: int, s: int, sms: int,
               plan: Optional[Tuple] = None) -> List[Choice]:
    """The hand-set choice and its neighbours, unpruned.  K1/K5's decode
    candidates are ``plan`` alone where the geometry has one already."""
    out = {hand_choice(op, m, c, r, s, sms)}
    if op in ("lowrank_fwd", "lowrank_ffn"):
        nb = 2 if op == "lowrank_ffn" else 1
        plans = [plan] if plan is not None else _decode_plans(c, r, s, sms, nb)
        out = {ch for ch in out if ch.design == "large"}
        out |= {Choice("decode", tuple(p)) for p in plans}
        if m >= LARGE_MIN_M:
            out.add(Choice("large"))
    elif op == "lowrank_dx":
        blocks, tiles = -(-m // kb.DX_ROWS), -(-c // kb.DX_COLS)
        for g in {tiles, -(-tiles // 2), -(-tiles // 4), max(1, sms // blocks)}:
            g = max(1, min(g, tiles))
            out.add(Choice("dx", (g, min(blocks, max(1, sms // g)))))
    elif op in ("lowrank_du", "lowrank_dv"):
        (hand,) = next(iter(out)).plan
        boxes = -(-m // kb.BOX_M)
        out |= {Choice("split", (n,)) for n in {1, hand // 2, 2 * hand, 4 * hand}
                if 1 <= n <= boxes}
    elif op == "flash":
        units = k8.flash_unit_count(1, m, c)
        waves = -(-units // sms)
        out |= {Choice("flash", (g,)) for g in {-(-units // waves), min(units, sms // 2)}
                if g >= 1}
    return sorted(out, key=lambda ch: (ch.design, ch.plan))


def takes(m: int, c: int, choice: Choice) -> bool:
    """Whether the wrapper takes ``choice`` at a call of M rows (a choice
    tuned at another M of the bucket may not fit this one)."""
    if choice.design == "dx":
        g, groups = choice.plan
        return 1 <= groups <= -(-m // kb.DX_ROWS) and 1 <= g <= -(-c // kb.DX_COLS)
    if choice.design == "split":
        return 1 <= choice.plan[0] <= -(-m // kb.BOX_M)
    return True


# --------------------------------------------------------------------------
# measurement + search
# --------------------------------------------------------------------------

def _make_arrays(op: str, m: int, c: int, r: int, s: int, dtype, device):
    gen = torch.Generator(device=device).manual_seed(m + c + r + s)

    def rnd(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen, device=device) * scale).to(dtype)

    if op == "flash":  # one batch row, c heads, no grouping
        return (rnd(1, m, c, r, scale=r ** -0.5), rnd(1, s, c, r), rnd(1, s, c, r))
    x, u, v = rnd(m, c), rnd(c, r, scale=c ** -0.5), rnd(r, s, scale=r ** -0.5)
    if op == "lowrank_ffn":
        return x, u, v, rnd(c, r, scale=c ** -0.5), rnd(r, s, scale=r ** -0.5)
    if op in ("lowrank_dx", "lowrank_du", "lowrank_dv"):
        return x, u, v, rnd(m, s)
    return x, u, v


def _run_op(op: str, arrays, choice: Choice):
    """One dispatcher-level call of ``op`` under ``choice``: the entry the
    models' calls go through, so a plain version is taken (and captured)
    exactly where it would be there."""
    from repro_torch.kernels import ops

    if op == "lowrank_fwd":
        return ops._fwd(*arrays, True, choice=choice)
    if op == "lowrank_ffn":
        return ops._ffn(*arrays, True, choice=choice)
    if op == "flash":
        q, k, v = arrays
        return ops._flash(q, k, v, causal=True, q_scale=q.shape[-1] ** 0.5, choice=choice)
    x, u, v, dy = arrays
    if op == "lowrank_dx":
        return ops._dx(dy, u, v, True, choice=choice)
    if op == "lowrank_du":
        return ops._du(x, dy, v, u.dtype, True, choice=choice)
    return ops._dv(x, u, dy, v.dtype, True, choice=choice)


def measure_choice(op: str, arrays, choice: Choice, *, iters: int,
                   flush: Optional[torch.Tensor]) -> Tuple[float, List[str]]:
    """(median µs, fallback reasons) of one choice through the dispatcher.
    A non-empty reason list means a plain version ran, not the kernel: the
    call is not timed, and the caller must not record it as measured."""
    from repro_torch.kernels import ops

    with ops.capture_fallbacks() as fb, torch.no_grad():
        _run_op(op, arrays, choice)
    if fb:
        return math.nan, [f.reason for f in fb]
    with torch.no_grad():
        return time_fn(lambda: _run_op(op, arrays, choice), iters, flush) * 1e3, []


def _choose_plan(op: str, ms: Sequence[int], c: int, r: int, s: int, sms: int,
                 timed=None) -> Tuple:
    """The decode plan of one K1/K5 geometry, shared by all its M buckets:
    the candidate whose buckets, each taking the better of it and the
    large-M design, sum to the least time over ``ms``.  ``timed(op, shape,
    choice) -> (µs, fallback reasons)`` measures; without it (or where a
    plain version ran) the analytic model decides."""
    nb = 2 if op == "lowrank_ffn" else 1
    plans = roofline.prune_choices(op, ms[0], c, r, s, [Choice("decode", p) for p in
                                                       _decode_plans(c, r, s, sms, nb)])

    def cost(m, ch):
        if timed is not None:
            us, fb = timed(op, (m, c, r, s), ch)
            if not fb:
                return us
        return roofline.choice_time(op, m, c, r, s, ch) * 1e6

    totals = dict.fromkeys(plans, 0.0)
    for m in ms:  # one M's operands at a time
        large = cost(m, Choice("large")) if m >= LARGE_MIN_M else math.inf
        for ch in plans:
            totals[ch] += min(cost(m, ch), large)
    return min(plans, key=lambda ch: (totals[ch], ch.plan)).plan


def search(shapes: Sequence[Tuple[int, int, int, int]], *,
           ops_list: Sequence[str] = ("lowrank_fwd",), dtype=torch.bfloat16,
           table: Optional[TuningTable] = None,
           freeze_phases: Sequence[Optional[int]] = (None,), budget: int = 4,
           measure: Optional[bool] = None, iters: int = 20, device=None,
           verbose: bool = False) -> TuningTable:
    """Tune every (op, shape) pair into ``table`` (the active table by
    default; created if none), one entry under each of ``freeze_phases``.

    ``measure=None`` measures exactly when the kernels can run
    (``ops.kernel_available()``); otherwise the analytically best candidate
    is recorded with ``source="analytic"``.  Keys already present for this
    device kind are cache hits and skipped.  A measured key times the
    ``budget`` analytically best candidates and the hand-set choice.  K1's
    and K5's decode plan is chosen once a geometry, over every M of it in
    ``shapes`` (:func:`_choose_plan`), unless the table holds one."""
    from repro_torch.kernels import ops as kops

    if table is None:
        table = get_table() or TuningTable()
        set_table(table)
    kind = device_kind()
    if measure is None:
        measure = kops.kernel_available()
    device = torch.device(device or ("cuda" if torch.cuda.is_available() else "cpu"))
    sms = _sms()
    flush = (torch.empty(64 * 2 ** 20, dtype=torch.float32, device=device)  # 256 MB > L2
             if measure and device.type == "cuda" else None)
    timings: Dict[Tuple, Tuple[float, List[str]]] = {}  # (op, shape, choice) -> measure_choice
    arrays_at: Dict[Tuple, tuple] = {}

    def timed(op, shape, ch):
        if (op, shape, ch) not in timings:
            if (op, shape) not in arrays_at:
                arrays_at.clear()  # one shape's operands on the card at a time
                arrays_at[(op, shape)] = _make_arrays(op, *shape, dtype, device)
            timings[(op, shape, ch)] = measure_choice(op, arrays_at[(op, shape)], ch,
                                                      iters=iters, flush=flush)
        return timings[(op, shape, ch)]

    planned: Dict[Tuple, Tuple] = {}
    for op in ops_list:
        if op not in OPS:
            raise ValueError(f"unknown op {op!r}; the ops are {OPS}")
        for (m, c, r, s) in shapes:
            hits = {fp: table.lookup(op, m, c, r, s, dtype, freeze_phase=fp, kind=kind)
                    for fp in freeze_phases}
            if all(e is not None for e in hits.values()):
                if verbose:
                    e = next(iter(hits.values()))
                    print(f"cache-hit: {op} {m}x{c}x{r}x{s} -> {e.choice.text()} "
                          f"[{e.source}]", flush=True)
                continue
            hand = hand_choice(op, m, c, r, s, sms)
            shared = None
            if op in ("lowrank_fwd", "lowrank_ffn"):
                shared = table.shared_plan(op, c, r, s, dtype, kind) or planned.get((op, c, r, s))
                if shared is None:
                    ms = sorted({sh[0] for sh in shapes if tuple(sh[1:]) == (c, r, s)})
                    shared = planned[(op, c, r, s)] = _choose_plan(
                        op, ms, c, r, s, sms, timed if measure else None)
            cands = roofline.prune_choices(op, m, c, r, s,
                                           candidates(op, m, c, r, s, sms, shared))
            if not cands:
                continue

            def predicted(ch):
                return roofline.choice_time(op, m, c, r, s, ch) * 1e6

            entry = None
            if measure:
                took, reasons = {}, []
                # the hand-set choice is timed beside them, and wins only
                # where it is a candidate (not where a shared plan rules it out)
                todo = cands[:budget] + ([hand] if hand not in cands[:budget] else [])
                for ch in todo:
                    us, fb = timed(op, (m, c, r, s), ch)
                    if fb:  # a plain version ran: the timing is not the kernel's
                        reasons = fb
                        break
                    took[ch] = us
                if took and not reasons:
                    best = min((ch for ch in took if ch in cands), key=took.get)
                    entry = TuneEntry(best, us=took[best], source="measured",
                                      device_kind=kind, hand_us=took.get(hand, 0.0),
                                      predicted_us=predicted(best))
                elif reasons:
                    # demoted: the analytic winner with the reason, never a
                    # "measured" entry born from a plain version's run
                    entry = TuneEntry(cands[0], us=predicted(cands[0]), source="analytic",
                                      device_kind=kind, fallback_reason=reasons[0],
                                      predicted_us=predicted(cands[0]))
            if entry is None:
                entry = TuneEntry(cands[0], us=predicted(cands[0]), source="analytic",
                                  device_kind=kind, predicted_us=predicted(cands[0]))
            for fp, hit in hits.items():
                if hit is None:
                    table.put(op, m, c, r, s, dtype, entry, freeze_phase=fp)
            if verbose:
                hand_text = (f"; hand-set {hand.text()} {entry.hand_us:.1f}us"
                             if entry.hand_us else f"; hand-set {hand.text()}")
                print(f"tuned: {op} {m}x{c}x{r}x{s} -> {entry.choice.text()} "
                      f"{entry.us:.1f}us (predicted {entry.predicted_us:.1f}us) "
                      f"[{entry.source}]" + hand_text
                      + (f" fallback={entry.fallback_reason}" if entry.fallback_reason
                         else ""), flush=True)
    return table


# --------------------------------------------------------------------------
# CLI (run 1 fills the table; run 2 is all cache hits)
# --------------------------------------------------------------------------

def _parse_shape(text: str) -> Tuple[int, int, int, int]:
    parts = tuple(int(p) for p in text.lower().split("x"))
    if len(parts) != 4:
        raise ValueError(f"shape must be MxCxRxS, got {text!r}")
    return parts


def main(argv: Optional[Sequence[str]] = None) -> TuningTable:
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--table", required=True, help="tuning-table JSON path")
    ap.add_argument("--shapes", nargs="+", default=["256x512x128x256", "512x1024x128x512"],
                    help="MxCxRxS shapes to tune (flash: Sq x heads x head dim x Sk)")
    ap.add_argument("--ops", nargs="+", default=["lowrank_fwd", "lowrank_dx"],
                    choices=list(OPS))
    ap.add_argument("--budget", type=int, default=4,
                    help="candidates measured per key (analytically best k), beside the "
                         "hand-set choice")
    ap.add_argument("--freeze-phase", type=int, nargs="+", default=[-1],
                    help="freeze phases to record each entry under (-1: none; the train "
                         "step looks up its phase's)")
    ap.add_argument("--iters", type=int, default=20, help="timed launches per candidate")
    args = ap.parse_args(argv)

    table = load_table(args.table)
    loaded = len(table)
    print(f"table {args.table}: {loaded} entries loaded "
          f"({'cache' if loaded else 'fresh'}), device_kind={device_kind()}", flush=True)
    search([_parse_shape(t) for t in args.shapes], ops_list=args.ops, table=table,
           budget=args.budget, iters=args.iters,
           freeze_phases=[None if fp < 0 else fp for fp in args.freeze_phase], verbose=True)
    path = table.save()
    print(f"saved {len(table)} entries -> {path}", flush=True)
    return table


if __name__ == "__main__":
    main()
