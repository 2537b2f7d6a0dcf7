"""``repro_torch.analysis.cost.count_step`` against the JAX package's HLO
count (``repro.analysis.hlo.analyze_hlo``, used as in
``tests/test_distributed.py``'s parser tests) for the same step compiled on
one CPU device: the smoke smollm-360m (float32, 2 layers, LRD at Eq.-5
ranks, min_dim 16) on params made in JAX, through the plain path.

A prefill and a decode step count the same FLOPs exactly.  A train step
counts more, for one cause the test names and computes: the port's
backward (``kernels/ops.py``, the K2-K4 kernels' contract) forms each
gradient on its own, where XLA shares work between them:

* dx and dU each form ``dy V^T`` (K2 and K3 each run their phase 1): one
  ``2 M S r`` more wherever both are computed (phases -1 and 1);
* dV forms ``x U`` again (K4's phase 1), where JAX keeps it from the
  forward: ``2 M C r`` more wherever dV is computed (phases -1 and 0);
* the gated FFN's backward recomputes both branches' pre-activations
  (``_LowrankGatedFFN.backward``): ``2 M C r + 2 M r F`` more a branch.

Also: the count's total equals ``FlopCounterMode``'s on the same step;
a step counts alike on the CPU and on the meta device, and with the
kernels on the meta device prices each kernel at the plain version's
FLOPs, one launch for each plain call the CPU made."""

import functools
from collections import Counter

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from repro.analysis.hlo import analyze_hlo
from repro.configs import get_smoke_config
from repro.configs.base import DistConfig, LRDConfig, OptimConfig, RunConfig, ShapeConfig
from repro.data import LMBatchIterator
from repro.launch import steps as jsteps
from repro.launch.mesh import make_host_mesh
from repro.models import lm as jlm
from repro_torch import bridge
from repro_torch.analysis.cost import count_step
from repro_torch.configs import get_smoke_config as t_get_smoke_config
from repro_torch.configs.base import DistConfig as TDistConfig
from repro_torch.configs.base import LRDConfig as TLRDConfig
from repro_torch.configs.base import OptimConfig as TOptimConfig
from repro_torch.configs.base import RunConfig as TRunConfig
from repro_torch.configs.base import ShapeConfig as TShapeConfig
from repro_torch.core.decompose import iter_factor_groups
from repro_torch.kernels import ops
from repro_torch.launch import steps
from repro_torch.models import lm

torch.set_num_threads(1)

ARCH, SEQ, BATCH = "smollm-360m", 16, 4
M = SEQ * BATCH
# the parser's own bound (the scan test of tests/test_distributed.py); at
# these shapes the named excess accounts for every FLOP, so the counts
# agree to rounding
FLOP_RTOL = 1e-9
# the wrapper each plain call the CPU records stands for
FALLBACK_OPS = {"lowrank_fwd": "lowrank_matmul", "lowrank_ffn": "lowrank_gated_ffn",
                "lowrank_dx": "lowrank_matmul_dx", "lowrank_du": "lowrank_matmul_du",
                "lowrank_dv": "lowrank_matmul_dv"}


def _runs(kind="train", kernels=False):
    lrd = dict(enabled=True, min_dim=16, freeze_mode="sequential", rank_quantize=False)
    jrun = RunConfig(model=get_smoke_config(ARCH), shape=ShapeConfig("t", SEQ, BATCH, kind),
                     lrd=LRDConfig(**lrd), dist=DistConfig(fsdp=False, remat="none"),
                     optim=OptimConfig(name="sgdm"))
    trun = TRunConfig(model=t_get_smoke_config(ARCH), shape=TShapeConfig("t", SEQ, BATCH, kind),
                      lrd=TLRDConfig(**lrd, use_pallas_kernel=kernels),
                      dist=TDistConfig(fsdp=False, remat="none"), optim=TOptimConfig(name="sgdm"))
    return jrun, trun


@functools.lru_cache(maxsize=None)
def _params():
    jrun, _ = _runs()
    params, _ = jsteps.init_params(jrun, jax.random.PRNGKey(0))
    return jax.tree_util.tree_map(np.asarray, params)


def _batch():
    return next(iter(LMBatchIterator(get_smoke_config(ARCH).vocab_size, SEQ, BATCH, seed=0)))


def _jax_flops(fn, *args) -> float:
    return analyze_hlo(jax.jit(fn).lower(*args).compile().as_text()).flops


def _backward_excess(params, phase: int) -> int:
    """The FLOPs the port's backward forms again (module docstring)."""
    total = 0
    for path, g in iter_factor_groups(params):
        u, v = g["u"], g["v"]
        layers = u.shape[0] if u.dim() == 3 else 1
        c, r, s = u.shape[-2], u.shape[-1], v.shape[-1]
        extra = 0
        if path.endswith(("/gate", "/up")):
            extra += 2 * M * c * r + 2 * M * r * s
        if phase != 0:
            extra += 2 * M * s * r
        if phase != 1:
            extra += 2 * M * c * r
        total += layers * extra
    return total


@pytest.mark.parametrize("phase", [-1, 0, 1])
def test_train_step_flops_match_jax_but_for_the_backward_recompute(phase):
    jrun, trun = _runs()
    params, batch = _params(), _batch()
    jstate, jparked = jsteps.make_train_state(jrun.optim, params, phase)
    want = _jax_flops(functools.partial(jsteps.build_train_step(jrun, make_host_mesh(1, 1)),
                                        phase=phase),
                      jstate, {k: jnp.asarray(v) for k, v in batch.items()})
    state, _ = bridge.train_state_from_jax(jstate, jparked)
    got = count_step(steps.build_train_step(trun, device="cpu"), state,
                     bridge.batch_from_numpy(batch), phase=phase)
    excess = _backward_excess(state.params, phase)
    assert excess > 0 and got.flops > want
    assert abs(got.flops - excess - want) <= FLOP_RTOL * want, (got.flops, excess, want)
    # the plain path computes in float32 throughout; nothing is launched
    assert set(got.flops_by_dtype) == {"float32"} and not got.kernel_launches


def test_prefill_flops_match_jax():
    jrun, trun = _runs("prefill")
    params = _params()
    tokens = _batch()["tokens"]
    want = _jax_flops(jsteps.build_prefill_step(jrun, make_host_mesh(1, 1)), params,
                      {"tokens": jnp.asarray(tokens)})
    got = count_step(steps.build_prefill_step(trun), bridge.params_from_jax(params),
                     {"tokens": torch.as_tensor(tokens)})
    assert abs(got.flops - want) <= FLOP_RTOL * want, (got.flops, want)
    assert got.bytes > 0 and got.collective_bytes == {} and got.total_collective_bytes == 0


@pytest.mark.parametrize("pos", [0, 5, 31])
def test_decode_flops_match_jax(pos):
    jrun, trun = _runs("decode")
    params = _params()
    cache = jlm.init_cache(jrun.model, BATCH, 32)
    want = _jax_flops(jsteps.build_serve_step(jrun, make_host_mesh(1, 1)), params, cache,
                      jnp.zeros((BATCH, 1), jnp.int32), jnp.asarray(pos, jnp.int32))
    got = count_step(steps.build_serve_step(trun), bridge.params_from_jax(params),
                     lm.init_cache(trun.model, BATCH, 32, "cpu"),
                     torch.zeros((BATCH, 1), dtype=torch.int32),
                     torch.tensor(pos, dtype=torch.int32))
    assert abs(got.flops - want) <= FLOP_RTOL * want, (got.flops, want)


@pytest.mark.parametrize("phase", [-1, 0, 1])
def test_count_equals_flop_counter_mode(phase):
    _, trun = _runs()
    jstate, jparked = jsteps.make_train_state(_runs()[0].optim, _params(), phase)
    step = steps.build_train_step(trun, device="cpu")
    batch = bridge.batch_from_numpy(_batch())
    state, _ = bridge.train_state_from_jax(jstate, jparked)
    got = count_step(step, state, batch, phase=phase)
    state, _ = bridge.train_state_from_jax(jstate, jparked)
    with FlopCounterMode(display=False) as fc:
        step(state, batch, phase=phase)
    assert got.flops == fc.get_total_flops() == sum(got.flops_by_dtype.values())


def _state(run, phase, device):
    params, _ = steps.init_params(run, device)
    return steps.make_train_state(run.optim, params, phase)[0]


def _int_batch(device):
    return {k: torch.zeros((BATCH, SEQ), dtype=torch.int32, device=device)
            for k in ("tokens", "labels")}


@pytest.mark.parametrize("phase", [-1, 0, 1])
def test_meta_counts_what_the_cpu_counts(phase):
    _, trun = _runs()
    got = {dev: count_step(steps.build_train_step(trun, device=dev, donate=True),
                           _state(trun, phase, dev), _int_batch(dev), phase=phase)
           for dev in ("cpu", "meta")}
    assert got["cpu"].to_json() == got["meta"].to_json()


@pytest.mark.parametrize("phase", [-1, 0, 1])
def test_meta_prices_each_kernel_call(phase):
    """bf16 params (the kernels' dtype) with the kernels on: the CPU runs
    each kernel call's plain version (a ``platform`` fallback), the meta
    device prices the kernel; the FLOPs are the same, and each plain call
    is one priced launch."""
    import dataclasses

    _, trun = _runs(kernels=True)
    trun = dataclasses.replace(trun, model=dataclasses.replace(
        trun.model, param_dtype="bfloat16", compute_dtype="bfloat16"))
    step = {dev: steps.build_train_step(trun, device=dev, donate=True) for dev in ("cpu", "meta")}
    with ops.capture_fallbacks() as fbs:
        cpu = count_step(step["cpu"], _state(trun, phase, "cpu"), _int_batch("cpu"), phase=phase)
    meta = count_step(step["meta"], _state(trun, phase, "meta"), _int_batch("meta"),
                      phase=phase)
    assert cpu.flops == meta.flops and not cpu.kernel_launches
    assert meta.kernel_launches == dict(Counter(FALLBACK_OPS[f.op] for f in fbs))
    assert meta.flops_by_dtype["bfloat16"] > 0
