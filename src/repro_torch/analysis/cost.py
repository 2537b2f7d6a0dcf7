"""FLOPs and bytes of one step, counted as it runs — the counterpart of
``repro/analysis/hlo.py``.

The reference parses compiled HLO: FLOPs of every dot and convolution,
bytes of every instruction's operands and output, collective bytes by
class, with scan bodies times their trip counts.  The port runs eagerly and
launches its kernels through ``ctypes``, so it has no HLO and PyTorch's
dispatcher never sees a kernel.  :func:`count_step` therefore counts from
two sources while the step runs:

* every aten op, through a ``TorchDispatchMode``: FLOPs from
  ``torch.utils.flop_counter``'s formulas (the registry
  ``FlopCounterMode`` counts with: matmuls, convolutions, attention),
  attributed to the dtype of the op's first operand, and bytes as the
  op's operands plus its outputs; views, metadata ops and allocations move
  nothing and are skipped (as ``hlo._SKIP_BYTES`` skips bitcasts and
  tuples).  One mode, not ``FlopCounterMode`` beside it: each mode costs
  the host tens of µs an op, and a full-width train step runs ~20,000 ops
  a microbatch (the tests hold the totals equal);
* every hand-written kernel, priced by ``roofline.kernel_cost`` at each
  shape it ran at: on CUDA from the wrappers' ``launches_by_shape``, on
  the meta device (``launch/dryrun.py``) from their ``priced_by_shape``.

Both sources see the same calls on the card and on meta, so a step counted
on meta gives the card's numbers.  ``collective_bytes`` holds the bytes of
the step's collectives by class (``all-reduce``, ``all-gather``,
``reduce-scatter``, ``all-to-all``: the reference's ``hlo.sync_bytes``
terms, each operand's bytes on this rank), read from
``distributed.collectives``' records of a sharded step,
``collective_bytes_by_dtype`` the same by ``"<class> <dtype>"``, and
``collective_bytes_by_path`` by ``"<class> <path>"`` (a MoE layer's
exchanges are ``all-to-all moe/dispatch``, ``moe/dispatch_ids`` and
``moe/combine``); a step on one device has none.  The step also
records the peak of the bytes it allocated and held at once
(``peak_bytes``), tracked by storage with weakref finalizers: on meta that
is the dry-run's temp bytes.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import weakref
from collections import Counter
from typing import Dict

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from repro_torch.analysis import roofline
from repro_torch.distributed import collectives

__all__ = ["StepCost", "counting", "count_step", "kernel_wrappers"]

# aten ops that move no bytes: allocations, views the schema does not mark
# as aliasing, and metadata
_SKIP_BYTES = {"empty", "empty_like", "empty_strided", "new_empty", "new_empty_strided",
               "_unsafe_view", "lift_fresh", "detach", "alias", "resize_", "set_",
               "_local_scalar_dense", "sym_size", "sym_stride", "sym_numel"}
# elementwise ops a transcendental unit computes, one a result element
_TRANSCENDENTAL = {"exp", "exp2", "expm1", "log", "log1p", "log2", "tanh", "sigmoid", "silu",
                   "gelu", "erf", "rsqrt", "sqrt", "sin", "cos", "pow", "_softmax",
                   "_log_softmax"}


@dataclasses.dataclass
class StepCost:
    """``hlo.HloCost``'s fields for one step of the port, plus its FLOPs by
    dtype, the hand-written kernels' launches by wrapper, and the peak of
    the bytes it allocated and held at once."""

    flops: float = 0.0
    bytes: float = 0.0
    transcendental_elems: float = 0.0
    collective_bytes: Dict[str, float] = dataclasses.field(default_factory=dict)
    collective_bytes_by_dtype: Dict[str, float] = dataclasses.field(default_factory=dict)
    collective_bytes_by_path: Dict[str, float] = dataclasses.field(default_factory=dict)
    bytes_by_op: Dict[str, float] = dataclasses.field(default_factory=dict)
    flops_by_dtype: Dict[str, float] = dataclasses.field(default_factory=dict)
    kernel_launches: Dict[str, int] = dataclasses.field(default_factory=dict)
    peak_bytes: int = 0

    @property
    def total_collective_bytes(self) -> float:
        return sum(self.collective_bytes.values())

    def _add(self, op: str, dtype: str, flops: float, nbytes: float) -> None:
        self.flops += flops
        self.bytes += nbytes
        if flops:
            self.flops_by_dtype[dtype] = self.flops_by_dtype.get(dtype, 0.0) + flops
        if nbytes:
            self.bytes_by_op[op] = self.bytes_by_op.get(op, 0.0) + nbytes

    def to_json(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_json(cls, d: dict) -> "StepCost":
        return cls(**d)


def kernel_wrappers() -> Dict[str, object]:
    """name -> hand-written kernel wrapper (each with ``launches_by_shape``
    and ``priced_by_shape``)."""
    from repro_torch.kernels import int8_matmul as k67
    from repro_torch.kernels import lowrank_bwd as kb
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.lowrank_ffn import lowrank_gated_ffn
    from repro_torch.kernels.lowrank_matmul import lowrank_matmul

    return {"lowrank_matmul": lowrank_matmul, "lowrank_gated_ffn": lowrank_gated_ffn,
            "lowrank_matmul_dx": kb.lowrank_matmul_dx, "lowrank_matmul_du": kb.lowrank_matmul_du,
            "lowrank_matmul_dv": kb.lowrank_matmul_dv, "int8_matmul": k67.int8_matmul,
            "int8_linear": k67.int8_linear, "int8_lowrank_matmul": k67.int8_lowrank_matmul,
            "int8_lowrank_linear": k67.int8_lowrank_linear, "flash_attention": flash_attention}


_FLASH_KEYS = ("B", "Sq", "Sk", "H", "KV", "D", "Dv", "causal")


def _dims(name: str, key: tuple) -> dict:
    """A wrapper's ``launches_by_shape`` key as ``kernel_cost``'s dims."""
    if name == "flash_attention":
        return dict(zip(_FLASH_KEYS, key))
    if name == "lowrank_gated_ffn":
        return dict(zip(("M", "C", "rg", "ru", "F"), key))
    if name in ("int8_matmul", "int8_linear"):
        return dict(zip(("M", "C", "S"), key))
    return dict(zip(("M", "C", "r", "S"), key))


def _tensors(xs):
    """The tensors among ``xs`` and inside its lists and tuples (aten
    arguments nest no deeper)."""
    out = []
    for x in xs:
        if isinstance(x, torch.Tensor):
            out.append(x)
        elif isinstance(x, (list, tuple)):
            out.extend(t for t in x if isinstance(t, torch.Tensor))
    return out


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


@functools.lru_cache(maxsize=None)
def _op_info(func):
    """(name, counts bytes, flop formula or None, which returns are fresh,
    decomposes) of an aten overload, looked up once."""
    name = func.overloadpacket.__name__
    fresh = tuple(ret.alias_info is None for ret in func._schema.returns)
    formula = flop_registry.get(func.overloadpacket)
    composite = formula is None and torch._C._dispatch_has_kernel_for_dispatch_key(
        func.name(), torch._C.DispatchKey.CompositeImplicitAutograd)
    # a collective's bytes are the records' (collective_bytes), not HBM bytes
    moves = not func.is_view and name not in _SKIP_BYTES and func.namespace != "c10d"
    return name, moves, formula, fresh, composite


class _Counting(TorchDispatchMode):
    """Sums each aten op's FLOPs (by dtype) and bytes into ``cost`` and
    tracks the live bytes of the storages the ops allocate."""

    def __init__(self, cost: StepCost):
        super().__init__()
        self.cost = cost
        self.live: Dict[int, int] = {}
        self.live_bytes = 0

    def _release(self, key: int) -> None:
        self.live_bytes -= self.live.pop(key, 0)

    def _track(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        key = id(st)
        if key in self.live:
            return
        n = st.nbytes()
        self.live[key] = n
        self.live_bytes += n
        if self.live_bytes > self.cost.peak_bytes:
            self.cost.peak_bytes = self.live_bytes
        weakref.finalize(st, self._release, key)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        name, moves, formula, fresh, composite = _op_info(func)
        if composite:
            # a composite op (matmul, einsum, softmax under inference mode)
            # is counted as the ops it decomposes into, as FlopCounterMode
            # counts it, so grad and inference mode count alike
            with self:
                out = func.decompose(*args, **kwargs)
            if out is not NotImplemented:
                return out
        out = func(*args, **kwargs)
        outs = out if isinstance(out, (tuple, list)) else (out,)
        cost = self.cost
        if moves or formula is not None:
            ins = _tensors(args) + _tensors(kwargs.values())
            if formula is not None:
                flops = formula(*args, **kwargs, out_val=out)
                cost.flops += flops
                dt = str(ins[0].dtype)[6:]  # "torch.<name>"
                cost.flops_by_dtype[dt] = cost.flops_by_dtype.get(dt, 0) + flops
            if moves:
                nbytes = sum(map(_nbytes, ins)) + sum(map(_nbytes, _tensors(outs)))
                cost.bytes += nbytes
                cost.bytes_by_op[name] = cost.bytes_by_op.get(name, 0) + nbytes
        if name in _TRANSCENDENTAL:
            cost.transcendental_elems += sum(t.numel() for t in _tensors(outs))
        # fresh storage: a returned tensor the schema does not alias to an input
        for is_fresh, t in zip(fresh, outs):
            if is_fresh and isinstance(t, torch.Tensor):
                self._track(t)
        return out


@contextlib.contextmanager
def counting():
    """Count every aten op and hand-written kernel run while open into the
    yielded :class:`StepCost` (filled in when the block exits)."""
    wrappers = kernel_wrappers()
    before = {n: (Counter(w.launches_by_shape), Counter(w.priced_by_shape))
              for n, w in wrappers.items()}
    cost = StepCost()
    with collectives.recording() as log, _Counting(cost):
        yield cost
    sync = [c for c in log if c.op in collectives.CLASSES]
    cost.collective_bytes = {k: float(v) for k, v in collectives.by_op(sync).items()}
    cost.collective_bytes_by_dtype = {k: float(v)
                                      for k, v in collectives.by_op_dtype(sync).items()}
    cost.collective_bytes_by_path = {k: float(v)
                                     for k, v in collectives.by_op_path(sync).items()}
    for name, w in wrappers.items():
        launched, priced = before[name]
        calls = (Counter(w.launches_by_shape) - launched) + (Counter(w.priced_by_shape) - priced)
        for key, n in calls.items():
            op_dtype = "int8" if name in roofline.INT8_OPS else "bfloat16"
            flops, nbytes = roofline.kernel_cost(name, _dims(name, key))
            cost._add(name, op_dtype, n * flops, n * nbytes)
        if calls:
            cost.kernel_launches[name] = sum(calls.values())


def count_step(fn, *args, **kwargs) -> StepCost:
    """The :class:`StepCost` of one call ``fn(*args, **kwargs)`` (its
    result is dropped: use :func:`counting` to keep it)."""
    with counting() as cost:
        fn(*args, **kwargs)
    return cost
