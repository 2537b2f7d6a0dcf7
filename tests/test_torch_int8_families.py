"""The int8 serving export of the SSM (xLSTM), hybrid (Zamba2), enc-dec
(seamless-m4t-medium) and VLM (llama-3.2-vision-90b) families in the port
against the JAX package, on the same weights (made once in JAX, carried
over by ``repro_torch.bridge``), float32 smoke configs, LRD on at Eq.-5
ranks, cross gates a seeded non-zero draw:

* the port's analytic int8 export against JAX's: the same report, the
  same leaves up to LAPACK rounding (``LEAF_RTOL``);
* the prefill's last-position logits on the JAX-exported int8 tree: JAX
  through its interpret-mode int8 kernels (blocks that divide every
  dimension, so no int8 op falls back), the port with the kernels
  requested, i.e. their plain versions on the CPU, within ``LOGIT_RTOL`` of
  max |logit|.  The enc-dec encoder runs with the policy off in both, as
  JAX's ``encode`` does: its int8 groups take the weight-only formula;
* greedy tokens of both ``ServeEngine``s on the fixed-batch path with
  ``export="analytic", export_int8=True`` (enc-dec's frames and the VLM's
  vision embeddings as ``extras``), the kernels requested on both sides;
* the serve CLI with ``--export analytic --export-int8 --device cpu``.

Each case's config is widened where its smoke config alone would leave the
analytic export one-sided: seamless-m4t-medium at d_model 256 and d_ff 512
keeps its FFN factorised (K7's path) and merges its 64-wide attention
(K6's).  Every xLSTM projection has one geometry, (d, d), so the analytic
export treats them alike: the smoke width merges all five (K6) and d_model
256 keeps all five factorised (K7), two cases of one family.  Zamba2's and
the VLM's smoke configs already do both: the Mamba2 groups and the VLM's
self-attention stack are stacked on two axes and truncate, their tails and
cross blocks merge.
"""

import dataclasses
import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config
from repro.configs.base import DistConfig, LRDConfig, RunConfig, ShapeConfig
from repro.kernels import ops as jops
from repro.launch import steps as jsteps
from repro.launch.mesh import make_host_mesh
from repro.models import encdec as jed
from repro.serving import ServeConfig as JServeConfig
from repro.serving import ServeEngine as JServeEngine
from repro.serving.export import export_for_serving as j_export
from repro_torch import bridge
from repro_torch.configs import get_smoke_config as t_get_smoke_config
from repro_torch.configs.base import DistConfig as TDist
from repro_torch.configs.base import LRDConfig as TLRD
from repro_torch.configs.base import RunConfig as TRun
from repro_torch.configs.base import ShapeConfig as TShape
from repro_torch.kernels import ops as tops
from repro_torch.launch import serve as tserve
from repro_torch.launch import steps as tsteps
from repro_torch.serving import ServeConfig, ServeEngine
from repro_torch.serving.export import export_for_serving as t_export

torch.set_num_threads(1)

# case -> (arch, widening of its smoke config)
CASES = {
    "xlstm-350m": ("xlstm-350m", dict(d_model=256)),
    "xlstm-350m-merged": ("xlstm-350m", {}),
    "zamba2-1.2b": ("zamba2-1.2b", {}),
    "seamless-m4t-medium": ("seamless-m4t-medium", dict(d_model=256, d_ff=512)),
    "llama-3.2-vision-90b": ("llama-3.2-vision-90b", {}),
}
ARCHS = sorted({arch for arch, _ in CASES.values()})
# logits on the same int8 tree, relative to max |logit|: one float32 ulp of
# a value at a rounding boundary flips one int8 step of an activation
LOGIT_RTOL = 1e-3
# float leaves of the two exports, relative to the leaf's max: the two
# LAPACKs' r x r SVDs round differently (tests/test_torch_export.py)
LEAF_RTOL = 1e-3
PROBE = 1  # the fixed-batch engine's probe_tokens, max(num_slots, 1)
BATCH, PROMPT, MAX_NEW = 2, 8, 6
# the path of each family's cross gate: seeded non-zero, or the decoder
# ignores the memory and the image tokens
_GATES = {"seamless-m4t-medium": ("dec_stack", "cross_attn", "gate"),
          "llama-3.2-vision-90b": ("cross_stack", "attn", "gate")}


def _lrd(**kw):
    return dict(enabled=True, min_dim=16, rank_quantize=False, **kw)


def _cfgs(case):
    arch, wide = CASES[case]
    return (dataclasses.replace(get_smoke_config(arch), **wide),
            dataclasses.replace(t_get_smoke_config(arch), **wide))


@functools.lru_cache(maxsize=None)
def _params(case):
    arch = CASES[case][0]
    jcfg, _ = _cfgs(case)
    run = RunConfig(model=jcfg, shape=ShapeConfig("s", 16, BATCH, "decode"),
                    lrd=LRDConfig(**_lrd()), dist=DistConfig(fsdp=False, remat="none"))
    jparams, _ = jsteps.init_params(run, jax.random.PRNGKey(11))
    jparams = jax.tree_util.tree_map(np.asarray, jparams)
    if arch in _GATES:
        *outer, leaf = _GATES[arch]
        node = functools.reduce(lambda t, k: t[k], outer, jparams)
        rng = np.random.default_rng(21)
        node[leaf] = (rng.uniform(0.3, 1.2, node[leaf].shape)
                      * rng.choice([-1.0, 1.0], node[leaf].shape)).astype(node[leaf].dtype)
    return jparams, bridge.params_from_jax(jparams)


def _leaves(tree, path=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{path}/{k}")
    else:
        yield path, tree


def _extras(case, rows, seed=5):
    """The family's ``generate`` extras as numpy: stub frames or vision
    embeddings, N(0, 0.1) from ``seed``."""
    jcfg, _ = _cfgs(case)
    n = {"encdec": jcfg.encoder_frames, "vlm": jcfg.num_image_tokens}.get(jcfg.family)
    if n is None:
        return {}
    key = "frames" if jcfg.family == "encdec" else "vision_embeddings"
    return {key: np.random.default_rng(seed).normal(0, 0.1, (rows, n, jcfg.d_model))
            .astype(np.float32)}


def _blocks(tree, ms):
    """JAX int8 kernel blocks that divide every int8 group's C and S and
    every M in ``ms``: no int8 op falls back for indivisible shapes."""
    cs, ss = [], []
    for path, leaf in _leaves(tree):
        if path.endswith(("/kernel_q", "/u_q")):
            cs.append(leaf.shape[-2])
            ss.append(leaf.shape[-1])
        if path.endswith("/v_q"):
            ss.append(leaf.shape[-1])
    return math.gcd(*ms), math.gcd(*cs), math.gcd(*ss)


def _runs(case, blocks, max_len):
    jcfg, tcfg = _cfgs(case)
    bm, bk, bn = blocks
    jrun = RunConfig(model=jcfg, shape=ShapeConfig("s", max_len, BATCH, "decode"),
                     lrd=LRDConfig(**_lrd(use_pallas_kernel=True, pallas_interpret=True,
                                          pallas_block_m=bm, pallas_block_k=bk,
                                          pallas_block_n=bn)),
                     dist=DistConfig(fsdp=False, remat="none"))
    trun = TRun(model=tcfg, shape=TShape("s", max_len, BATCH, "decode"),
                lrd=TLRD(**_lrd(use_pallas_kernel=True)), dist=TDist(fsdp=False, remat="none"))
    return jrun, trun


def _ms(case, tokens):
    """Every M an int8 op of a prefill of ``tokens`` and of a decode step
    sees: the tokens, a decode row each, the Mamba2 conv tail, the memory
    or the image tokens."""
    jcfg, _ = _cfgs(case)
    b, s = tokens.shape
    ms = [b * s, b]
    if jcfg.family == "hybrid":
        ms.append(b * (jcfg.ssm_conv_width - 1))
    ms += [b * e.shape[1] for e in _extras(case, b).values()]
    return ms


@pytest.mark.parametrize("case", list(CASES))
def test_export_matches_jax(case):
    jparams, tparams = _params(case)
    jtree, jrep = j_export(jparams, backend="analytic-tpu", probe_tokens=PROBE,
                           quantize_factors="int8")
    ttree, trep = t_export(tparams, backend="analytic-tpu", probe_tokens=PROBE,
                           quantize_factors="int8")
    assert {p: dataclasses.asdict(l) for p, l in trep.layers.items()} == {
        p: dataclasses.asdict(l) for p, l in jrep.layers.items()}
    assert trep.summary() == jrep.summary()
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
            np.testing.assert_allclose(ta.float().numpy(), ja.astype(np.float32),
                                       rtol=LEAF_RTOL, atol=LEAF_RTOL * np.abs(ja).max(),
                                       err_msg=path)
    assert n_int8 and n_equal >= 0.999 * n_int8, (n_equal, n_int8)
    keys = {p.rsplit("/", 1)[-1] for p in tl}
    assert not {"u", "v"} & keys
    merged = [l.merged for l in trep.layers.values()]
    if case == "xlstm-350m-merged":
        assert all(merged) and "u_q" not in keys
    else:
        assert not all(merged) and "u_q" in keys
        if case != "xlstm-350m":
            assert any(merged) and "kernel_q" in keys


def test_every_family_reaches_both_int8_paths():
    """Over each family's cases the analytic export both keeps a group
    factorised (K7's u_q) and merges one (K6's kernel_q)."""
    for arch in ARCHS:
        seen = set()
        for case, (a, _) in CASES.items():
            if a == arch:
                tree, _ = t_export(_params(case)[1], backend="analytic-tpu",
                                   probe_tokens=PROBE, quantize_factors="int8")
                seen |= {p.rsplit("/", 1)[-1] for p, _ in _leaves(tree)}
        assert {"u_q", "kernel_q"} <= seen, arch


@pytest.mark.parametrize("case", list(CASES))
def test_logits_on_the_jax_int8_tree_match(case):
    jparams, _ = _params(case)
    jtree, _ = j_export(jparams, backend="analytic-tpu", probe_tokens=PROBE,
                        quantize_factors="int8")
    ttree = bridge.params_from_jax(jax.tree_util.tree_map(np.asarray, jtree))
    jcfg, _ = _cfgs(case)
    tokens = np.random.default_rng(7).integers(0, jcfg.vocab_size, (BATCH, PROMPT),
                                               dtype=np.int32)
    extras = _extras(case, BATCH)
    jrun, trun = _runs(case, _blocks(jtree, _ms(case, tokens)), PROMPT)
    with jops.capture_fallbacks() as jfb:
        want, _ = jsteps.build_prefill_step(jrun, make_host_mesh(1, 1))(
            jtree, {"tokens": jnp.asarray(tokens),
                    **{k: jnp.asarray(v) for k, v in extras.items()}})
    j_int8 = {(f.op, f.reason) for f in jfb if f.op.startswith("int8")}
    # only the enc-dec encoder's, which runs with the policy off
    assert j_int8 == ({("int8_dense", "disabled"), ("int8_lowrank", "disabled")}
                      if jcfg.family == "encdec" else set()), j_int8
    with tops.capture_fallbacks() as tfb:
        got, _ = tsteps.build_prefill_step(trun)(
            ttree, {"tokens": torch.from_numpy(tokens),
                    **{k: torch.from_numpy(v) for k, v in extras.items()}})
    # every int8 group the tree holds ran its kernel's plain version (the
    # enc-dec encoder's the weight-only formula, as in JAX)
    keys = {p.rsplit("/", 1)[-1] for p, _ in _leaves(ttree)}
    held = {op for op, key in (("int8_dense", "kernel_q"), ("int8_lowrank", "u_q"))
            if key in keys}
    assert {f.op for f in tfb} == held
    assert {f.reason for f in tfb} == ({"platform", "disabled"} if jcfg.family == "encdec"
                                       else {"platform"})
    want = np.asarray(want, np.float32)
    err = np.abs(got.float().numpy() - want).max()
    assert err <= LOGIT_RTOL * np.abs(want).max(), err


@pytest.mark.parametrize("case", list(CASES))
def test_engines_serve_the_int8_export_with_the_same_tokens(case):
    jparams, tparams = _params(case)
    jcfg, _ = _cfgs(case)
    prompts = np.random.default_rng(14).integers(0, jcfg.vocab_size, (BATCH, PROMPT),
                                                 dtype=np.int32)
    extras = _extras(case, BATCH, seed=15)
    jtree, _ = j_export(jparams, backend="analytic-tpu", probe_tokens=PROBE,
                        quantize_factors="int8")
    jrun, trun = _runs(case, _blocks(jtree, _ms(case, prompts)), PROMPT + MAX_NEW)
    kw = dict(export="analytic", export_int8=True)
    jeng = JServeEngine(jrun, jparams, config=JServeConfig(**kw))
    jextras = {k: jnp.asarray(v) for k, v in extras.items()}
    if jcfg.family == "encdec":  # JAX's decode steps read the memory from extras
        jextras["memory"] = jed.encode(jeng.params, jextras["frames"], jcfg)
    with jops.capture_fallbacks() as jfb:
        want = np.asarray(jeng.generate(prompts, max_new=MAX_NEW, extras=jextras or None))
    assert not [f for f in jfb if f.op.startswith("int8") and f.reason != "disabled"], jfb
    teng = ServeEngine(trun, tparams, config=ServeConfig(**kw), device="cpu")
    with tops.capture_fallbacks() as tfb:
        got = teng.generate(prompts, max_new=MAX_NEW,
                            extras={k: torch.from_numpy(v) for k, v in extras.items()} or None)
    np.testing.assert_array_equal(got, want)
    assert got.shape == (BATCH, MAX_NEW) and teng._scheduler is None
    assert teng.export_report.summary() == jeng.export_report.summary()
    assert {f.reason for f in tfb if f.op.startswith("int8")} <= {"platform", "disabled"}
    assert any(f.op.startswith("int8") and f.reason == "platform" for f in tfb)


@pytest.mark.parametrize("arch", ARCHS)
def test_cli_serves_the_int8_export(arch, capsys):
    argv = ["--arch", arch, "--smoke", "--device", "cpu", "--lrd", "--slots", "2",
            "--prompt-len", "8", "--max-new", "4", "--export", "analytic", "--export-int8"]
    with tops.capture_fallbacks() as fbs:
        engine, out = tserve.main(argv)
    assert out.shape == (2, 4) and engine._scheduler is None
    assert engine.export_report.summary() in capsys.readouterr().out
    keys = {p.rsplit("/", 1)[-1] for p, _ in _leaves(engine.params)}
    assert "kernel_q" in keys and not {"u", "v"} & keys
    assert all(l.quantized for l in engine.export_report.layers.values())
    # the CLI turns the kernels on only on CUDA: on the CPU every int8 group
    # takes the policy-off (weight-only) formula, as the JAX CLI's do there
    held = {op for op, key in (("int8_dense", "kernel_q"), ("int8_lowrank", "u_q"))
            if key in keys}
    assert {f.op for f in fbs} == held and {f.reason for f in fbs} == {"disabled"}
