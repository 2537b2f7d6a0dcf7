"""The serve-time export in the port against the JAX package, on the same
weights (made in JAX, carried over by ``repro_torch.bridge``): the same
Algorithm-1 report, the same int8 artifact up to LAPACK rounding, the
smoke model's logits on the JAX-exported int8 tree (JAX through its
interpret-mode int8 kernels, the port through their plain versions), the
same greedy tokens through both ``ServeEngine``s with ``export="analytic",
export_int8=True``, and the int8 tree through both packages' checkpoints.

The model is the smollm-360m smoke config widened so that the analytic
export keeps some groups factorised (d_model 256, d_ff 512: K7's path) and
merges others (one 64-wide KV head: K6's path)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import load_checkpoint as j_load
from repro.checkpoint import save_checkpoint as j_save
from repro.checkpoint.store import latest_checkpoint as j_latest
from repro.configs import get_smoke_config
from repro.configs.base import DistConfig, LRDConfig, RunConfig, ShapeConfig
from repro.kernels import ops as jops
from repro.launch import steps as jsteps
from repro.models import lm as jlm
from repro.serving import ServeConfig as JServeConfig
from repro.serving import ServeEngine as JServeEngine
from repro.serving.export import export_for_serving as j_export
from repro_torch import bridge
from repro_torch.checkpoint import store as tstore
from repro_torch.configs import get_smoke_config as t_get_smoke_config
from repro_torch.configs.base import LRDConfig as TLRD
from repro_torch.configs.base import RunConfig as TRun
from repro_torch.configs.base import ShapeConfig as TShape
from repro_torch.core import rank_opt as trank_opt
from repro_torch.kernels import ops as tops
from repro_torch.models import lm as tlm
from repro_torch.serving import ServeConfig, ServeEngine
from repro_torch.serving.export import export_for_serving as t_export

torch.set_num_threads(1)

WIDE = dict(d_model=256, num_heads=4, num_kv_heads=1, head_dim=64, d_ff=512)
# logits on the same int8 tree, relative to max |logit|: one float32 ulp of
# a value at a rounding boundary flips one int8 step of an activation
LOGIT_RTOL = 1e-3
# float leaves of the two exports (truncated factors and int8 scales),
# relative to the leaf's max: the two LAPACKs' r x r SVDs round differently,
# which moves single factor entries by a few 1e-5 of the leaf's max; the
# products, which the truncation determines, are held at 1e-4 below
LEAF_RTOL = 1e-3


def _runs(slots=2, max_len=32):
    jcfg = dataclasses.replace(get_smoke_config("smollm-360m"), **WIDE)
    tcfg = dataclasses.replace(t_get_smoke_config("smollm-360m"), **WIDE)
    jrun = RunConfig(model=jcfg, shape=ShapeConfig("s", max_len, slots, "decode"),
                     lrd=LRDConfig(enabled=True, min_dim=16, rank_quantize=False),
                     dist=DistConfig(fsdp=False, remat="none"))
    trun = TRun(model=tcfg, shape=TShape("s", max_len, slots, "decode"),
                lrd=TLRD(enabled=True, min_dim=16, rank_quantize=False))
    return jrun, trun


@pytest.fixture(scope="module")
def params():
    jrun, _ = _runs()
    jparams, _ = jsteps.init_params(jrun, jax.random.PRNGKey(5))
    return jparams, bridge.params_from_jax(jax.tree_util.tree_map(np.asarray, jparams))


def _leaves(tree, path=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{path}/{k}")
    else:
        yield path, tree


@pytest.mark.parametrize("probe_tokens", [2, 16])
@pytest.mark.parametrize("int8", [False, True])
def test_export_matches_jax(params, probe_tokens, int8):
    jparams, tparams = params
    q = "int8" if int8 else None
    jtree, jrep = j_export(jparams, backend="analytic-tpu", probe_tokens=probe_tokens,
                           quantize_factors=q)
    ttree, trep = t_export(tparams, backend="analytic-tpu", probe_tokens=probe_tokens,
                           quantize_factors=q)
    assert {p: dataclasses.asdict(l) for p, l in trep.layers.items()} == {
        p: dataclasses.asdict(l) for p, l in jrep.layers.items()}
    assert trep.summary() == jrep.summary()
    merged = [l.merged for l in trep.layers.values()]
    assert any(merged) and not all(merged)  # both K6's and K7's groups
    assert any(l.rank_serve < l.rank_train for l in trep.layers.values() if not l.merged)
    jl, tl = dict(_leaves(jtree)), dict(_leaves(ttree))
    assert sorted(jl) == sorted(tl)
    n_int8 = n_equal = 0
    for path, ja in jl.items():
        ja, ta = np.asarray(ja), tl[path]
        assert tuple(ta.shape) == ja.shape, path
        if ja.dtype == np.int8:
            assert ta.dtype == torch.int8, path
            diff = np.abs(ta.numpy().astype(np.int32) - ja.astype(np.int32))
            assert diff.max() <= 1, path
            n_int8 += diff.size
            n_equal += int((diff == 0).sum())
        else:
            got = ta.float().numpy()
            np.testing.assert_allclose(got, ja.astype(np.float32), rtol=LEAF_RTOL,
                                       atol=LEAF_RTOL * np.abs(ja).max(), err_msg=path)
    assert (n_int8 > 0) == int8
    if int8:
        assert n_equal >= 0.999 * n_int8, (n_equal, n_int8)
    if not int8:  # the truncated products agree
        for path, lay in trep.layers.items():
            if not lay.merged:
                jg, tg = jtree, ttree
                for k in path.split("/"):
                    jg, tg = jg[k], tg[k]
                want = np.asarray(jnp.matmul(jg["u"], jg["v"]))
                got = torch.matmul(tg["u"], tg["v"]).numpy()
                np.testing.assert_allclose(got, want, rtol=0, atol=1e-4 * np.abs(want).max())


def test_logits_on_the_jax_int8_tree_match(params):
    """The JAX-exported int8 tree through JAX's int8 kernels (interpret mode,
    blocks that divide every dimension: no int8 fallback) and through the
    port's dispatchers with the kernel requested (their plain versions)."""
    jparams, _ = params
    jrun, trun = _runs()
    jtree, _ = j_export(jparams, backend="analytic-tpu", probe_tokens=2,
                        quantize_factors="int8")
    ttree = bridge.params_from_jax(jax.tree_util.tree_map(np.asarray, jtree))
    tokens = np.random.default_rng(7).integers(0, jrun.model.vocab_size, (1, 16),
                                               dtype=np.int32)
    jpol = jops.KernelPolicy(use_pallas=True, interpret=True, block_m=16, block_k=128,
                             block_n=64)
    with jops.capture_fallbacks() as jfb:
        want, _, _ = jlm.lm_apply(jtree, jnp.asarray(tokens), jrun.model, mode="full",
                                  use_pallas=jpol)
    assert not [f for f in jfb if f.op.startswith("int8")], jfb
    with tops.capture_fallbacks() as tfb:
        got, _, _ = tlm.lm_apply(ttree, torch.from_numpy(tokens), trun.model, mode="full",
                                 policy=tops.KernelPolicy(use_kernel=True))
    ops_seen = {f.op for f in tfb}
    assert ops_seen == {"int8_dense", "int8_lowrank"} and {f.reason for f in tfb} == {
        "platform"}
    want = np.asarray(want, np.float32)
    err = np.abs(got.float().numpy() - want).max()
    assert err <= LOGIT_RTOL * np.abs(want).max(), err
    # as tests/test_int8_decode.py bounds it: with the kernels off, native
    # int8 decode (the weight-only formula) stays within 2e-2 of the bf16
    # round trip of the same tree
    outs = {mode: tlm.lm_apply(ttree, torch.from_numpy(tokens), trun.model, mode="full",
                               policy=tops.KernelPolicy(int8_decode=mode))[0].float()
            for mode in ("native", "bf16")}
    gap = (outs["native"] - outs["bf16"]).abs().max().item()
    assert gap <= max(2e-2, 2e-2 * outs["bf16"].abs().max().item())


def _trace(vocab):
    rng = np.random.default_rng(13)
    return [{"prompt": rng.integers(0, vocab, int(rng.integers(4, 14)), dtype=np.int32),
             "max_new": int(rng.integers(4, 9))} for _ in range(5)]


def test_engines_serve_the_int8_export_with_the_same_tokens(params):
    jparams, tparams = params
    jrun, trun = _runs()
    kw = dict(num_slots=2, max_len=32, prefill_len=16, block_size=8, export="analytic",
              export_int8=True)
    trace = _trace(jrun.model.vocab_size)
    jeng = JServeEngine(jrun, jparams, config=JServeConfig(**kw))
    want = jeng.serve(trace)
    teng = ServeEngine(trun, tparams, config=ServeConfig(**kw), device="cpu")
    got = teng.serve(trace)
    assert [r.tokens.tolist() for r in got] == [r.tokens.tolist() for r in want]
    assert [len(r) for r in got] == [r["max_new"] for r in trace]
    assert teng.export_report.summary() == jeng.export_report.summary()
    assert teng.scheduler.forward_stats["nonfinite"] == 0
    keys = {p.rsplit("/", 1)[-1] for p, _ in _leaves(teng.params)}
    assert {"kernel_q", "u_q", "v_q"} <= keys and not {"u", "v"} & keys


def _to_meta(tree):
    if isinstance(tree, dict):
        return {k: _to_meta(v) for k, v in tree.items()}
    return tree.to("meta")


class _Probed(Exception):
    pass


def test_measured_export_times_on_the_device_of_the_params(params, monkeypatch):
    """The measured backend probes where the factors lie (meta tensors stand
    in here for a card's), never on the host by default; the probe builder
    has no default device, and the engine refuses params that lie on
    another device than its own."""
    _, tparams = params
    meta = _to_meta(tparams)
    with pytest.raises(TypeError, match="device"):
        trank_opt.measured_linear_time_fn(8, 8, m=2)
    seen = []

    def probe_builder(c, s, *, device, m):
        seen.append(torch.device(device))
        raise _Probed

    monkeypatch.setattr(trank_opt, "measured_linear_time_fn", probe_builder)
    with pytest.raises(_Probed):
        t_export(meta, backend="measured", probe_tokens=2)
    assert seen == [torch.device("meta")]
    _, trun = _runs()
    cfg = ServeConfig(num_slots=2, max_len=32, prefill_len=16, block_size=8,
                      export="measured")
    with pytest.raises(ValueError, match="engine on cpu"):
        ServeEngine(trun, meta, config=cfg, device="cpu")
    assert len(seen) == 1  # refused before any probe


def test_int8_tree_round_trips_through_both_checkpoints(params, tmp_path):
    jparams, tparams = params
    ttree, _ = t_export(tparams, backend="analytic-tpu", probe_tokens=2,
                        quantize_factors="int8")
    jtree, _ = j_export(jparams, backend="analytic-tpu", probe_tokens=2,
                        quantize_factors="int8")
    # port -> JAX
    tstore.save_checkpoint(tmp_path / "t", 1, {"params": ttree}, extra={"export": "int8"})
    restored, step, extra = j_load(j_latest(tmp_path / "t"))
    assert step == 1 and extra["export"] == "int8"
    got = dict(_leaves(restored["params"]))
    for path, t in _leaves(ttree):
        a = np.asarray(got[path])
        assert a.dtype == (np.int8 if t.dtype == torch.int8 else np.float32), path
        np.testing.assert_array_equal(a, t.numpy())
    # JAX -> port
    j_save(tmp_path / "j", 2, {"params": jtree})
    restored, step, _ = tstore.load_checkpoint(tstore.latest_checkpoint(tmp_path / "j"))
    assert step == 2
    got = dict(_leaves(restored["params"]))
    for path, a in _leaves(jtree):
        a = np.asarray(a)
        t = got[path]
        assert t.dtype == (torch.int8 if a.dtype == np.int8 else torch.float32), path
        np.testing.assert_array_equal(t.numpy(), a)
    # and the bridge carries the same leaves both ways
    back = bridge.to_numpy(bridge.from_numpy(jax.tree_util.tree_map(np.asarray, jtree)))
    for (p1, a), (p2, b) in zip(_leaves(back), _leaves(jtree)):
        assert p1 == p2 and a.dtype == np.asarray(b).dtype
        np.testing.assert_array_equal(a, np.asarray(b))
