"""The port's state-space blocks (``repro_torch.models.ssm``) against the
JAX package's ``repro.models.ssm`` on the same weights (made in JAX,
carried over by ``repro_torch.bridge``) and the same numpy inputs: the
causal depthwise conv, chunked SSD, Mamba2 and mLSTM in full and decode
mode, float32 within 1e-5; prefill then one decode step against a full pass
over one more token; and the SSD decay's departure by design (a finite
gradient at a 256-token chunk, where the reference's is NaN)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config
from repro.core.decompose import Decomposer
from repro.core.policy import LM_DEFAULT
from repro.models import ssm as jssm
from repro_torch import bridge
from repro_torch.configs import get_smoke_config as t_get_smoke_config
from repro_torch.models import ssm as tssm

torch.set_num_threads(1)

TOL = 1e-5  # float32: the same products summed in another order
GRAD_RTOL = 1e-4  # a gradient through the SSD, relative to its largest entry
POLICY = LM_DEFAULT.with_quantize(False).with_min_dim(16)  # factorised in/out projections


def _cfgs(arch):
    return get_smoke_config(arch), t_get_smoke_config(arch)


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got, np.float32), np.asarray(want, np.float32),
                               rtol=0, atol=tol)


def _t(a):
    return torch.from_numpy(np.array(a, np.float32, copy=True))


def _block(arch, seed=0):
    """(JAX cfg, torch cfg, JAX params, torch params) of one Mamba2 (hybrid)
    or mLSTM (ssm) block, its projections factorised."""
    jcfg, tcfg = _cfgs(arch)
    init = jssm.mamba2_init if jcfg.family == "hybrid" else jssm.mlstm_init
    p = init(Decomposer(POLICY, dtype=jnp.float32), jax.random.PRNGKey(seed), "layers/blk",
             jcfg)
    if jcfg.family == "hybrid":
        # A_log, dt_bias and D off their init values, so the decay varies by head
        rng = np.random.default_rng(seed)
        nh = p["A_log"].shape[0]
        p = dict(p, A_log=jnp.asarray(rng.normal(0, 0.5, nh), jnp.float32),
                 dt_bias=jnp.asarray(rng.normal(0, 0.5, nh), jnp.float32),
                 D=jnp.asarray(rng.normal(1, 0.2, nh), jnp.float32))
    assert "u" in (p["in_proj"] if "in_proj" in p else p["wq"])
    return jcfg, tcfg, p, bridge.params_from_jax(jax.tree_util.tree_map(np.asarray, p))


def _x(seed, b, s, d, scale=1.0):
    return np.random.default_rng(seed).normal(0, scale, (b, s, d)).astype(np.float32)


# --------------------------------------------------------------------------
# conv1d
# --------------------------------------------------------------------------

def test_conv1d_matches_jax():
    rng = np.random.default_rng(0)
    w = rng.normal(0, 0.5, (4, 24)).astype(np.float32)
    x = rng.normal(0, 1, (2, 11, 24)).astype(np.float32)
    state = rng.normal(0, 1, (2, 3, 24)).astype(np.float32)
    jp, tp = {"kernel": jnp.asarray(w)}, {"kernel": _t(w)}
    _close(tssm.conv1d_apply(tp, _t(x)), jssm.conv1d_apply(jp, jnp.asarray(x)))
    ty, tstate = tssm.conv1d_step(tp, _t(state), _t(x[:, :1]))
    jy, jstate = jssm.conv1d_step(jp, jnp.asarray(state), jnp.asarray(x[:, :1]))
    _close(ty, jy)
    _close(tstate, jstate)


# --------------------------------------------------------------------------
# chunked SSD
# --------------------------------------------------------------------------

def _ssd_inputs(seed=0, b=2, s=16, h=3, p=4, n=5, dt_scale=0.5):
    rng = np.random.default_rng(seed)
    f = lambda *shape: rng.normal(0, 1, shape).astype(np.float32)
    x, bm, cm = f(b, s, h, p), f(b, s, h, n), f(b, s, h, n)
    dt = np.log1p(np.exp(dt_scale * f(b, s, h))).astype(np.float32)
    a_log, d = (0.5 * f(h)).astype(np.float32), f(h)
    init = f(b, h, n, p)
    return x, dt, a_log, bm, cm, d, init


@pytest.mark.parametrize("chunk,with_init", [(4, False), (8, True), (16, False)])
def test_ssd_chunked_matches_jax(chunk, with_init):
    x, dt, a_log, bm, cm, d, init = _ssd_inputs()
    init = init if with_init else None
    jy, js = jssm._ssd_chunked(*(jnp.asarray(a) for a in (x, dt, a_log, bm, cm, d)), chunk,
                               init_state=None if init is None else jnp.asarray(init))
    ty, ts = tssm._ssd_chunked(*(_t(a) for a in (x, dt, a_log, bm, cm, d)), chunk,
                               init_state=None if init is None else _t(init))
    _close(ty, jy)
    _close(ts, js)
    # SSD's output does not depend on the chunk length
    y16, s16 = tssm._ssd_chunked(*(_t(a) for a in (x, dt, a_log, bm, cm, d)), 16,
                                 init_state=None if init is None else _t(init))
    _close(ty, y16)
    _close(ts, s16)


def test_ssd_decay_gradient_is_finite_at_a_256_token_chunk():
    """The departure by design (ROADMAP queue 3): at chunk 256 with A_log =
    0 and dt near softplus(0) = 0.69, the reference's where(tri, exp(diff),
    0) overflows above the diagonal and its dt gradient is non-finite; the
    port's exp(where(tri, diff, -inf)) gives a finite one, equal (SSD's
    output does not depend on the chunk) to the reference's at chunk 64,
    where the reference's is finite."""
    rng = np.random.default_rng(0)
    b, s, h, p, n = 1, 256, 2, 8, 4
    x = rng.normal(0, 1, (b, s, h, p)).astype(np.float32)
    bm = rng.normal(0, 1, (b, s, h, n)).astype(np.float32)
    cm = rng.normal(0, 1, (b, s, h, n)).astype(np.float32)
    dt = np.log1p(np.exp(0.1 * rng.normal(0, 1, (b, s, h)))).astype(np.float32)
    a_log, d = np.zeros(h, np.float32), np.ones(h, np.float32)

    def jgrad(chunk):
        f = lambda dt_: jssm._ssd_chunked(jnp.asarray(x), dt_, jnp.asarray(a_log),
                                          jnp.asarray(bm), jnp.asarray(cm), jnp.asarray(d),
                                          chunk)[0].sum()
        return np.asarray(jax.grad(f)(jnp.asarray(dt)))

    assert not np.isfinite(jgrad(256)).all()
    want = jgrad(64)
    assert np.isfinite(want).all()
    tdt = _t(dt).requires_grad_(True)
    y, _ = tssm._ssd_chunked(_t(x), tdt, _t(a_log), _t(bm), _t(cm), _t(d), 256)
    (got,) = torch.autograd.grad(y.sum(), tdt)
    got = got.numpy()
    assert np.isfinite(got).all()
    assert np.abs(got - want).max() <= GRAD_RTOL * np.abs(want).max()


# --------------------------------------------------------------------------
# Mamba2 and mLSTM blocks
# --------------------------------------------------------------------------

def _apply(fam):
    return ((jssm.mamba2_apply, tssm.mamba2_apply) if fam == "hybrid"
            else (jssm.mlstm_apply, tssm.mlstm_apply))


ARCHS = ["zamba2-1.2b", "xlstm-350m"]


@pytest.mark.parametrize("arch", ARCHS)
def test_block_full_matches_jax(arch):
    jcfg, tcfg, jp, tp = _block(arch)
    japply, tapply = _apply(jcfg.family)
    x = _x(1, 2, 16, jcfg.d_model)
    jy, jst = japply(jp, jnp.asarray(x), jcfg, mode="full")
    ty, tst = tapply(tp, _t(x), tcfg, mode="full")
    _close(ty, jy)
    assert set(tst) == set(jst)
    for k in jst:
        _close(tst[k], jst[k])


@pytest.mark.parametrize("arch", ARCHS)
def test_block_decode_matches_jax(arch):
    """Three decode steps from a random state (the mLSTM's m stabiliser
    finite), each against JAX's."""
    jcfg, tcfg, jp, tp = _block(arch)
    japply, tapply = _apply(jcfg.family)
    b = 2
    init = (jssm.mamba2_init_state(jcfg, b, jnp.float32) if jcfg.family == "hybrid"
            else jssm.mlstm_init_state(jcfg, b, jnp.float32))
    rng = np.random.default_rng(3)
    state = {k: rng.normal(0, 0.5, v.shape).astype(np.float32) for k, v in init.items()}
    if "m" in state:
        state["m"] = np.abs(state["m"]).astype(np.float32)
    jstate = {k: jnp.asarray(v) for k, v in state.items()}
    tstate = {k: _t(v) for k, v in state.items()}
    for step in range(3):
        x = _x(10 + step, b, 1, jcfg.d_model)
        jy, jstate = japply(jp, jnp.asarray(x), jcfg, mode="decode", state=jstate)
        ty, tstate = tapply(tp, _t(x), tcfg, mode="decode", state=tstate)
        _close(ty, jy)
        for k in jstate:
            _close(tstate[k], jstate[k])
    assert tstate.get("m", torch.zeros(())).dtype == torch.float32


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_then_decode_equals_a_full_pass(arch):
    """Prefill of s tokens, then one decode step on token s, gives the full
    pass's output at position s (the states carry everything)."""
    _, tcfg, _, tp = _block(arch)
    tapply = _apply(tcfg.family)[1]
    s = 16
    x = _t(_x(5, 2, s + 1, tcfg.d_model))
    full, _ = tapply(tp, x, tcfg, mode="full")
    _, st = tapply(tp, x[:, :s], tcfg, mode="full")
    step, _ = tapply(tp, x[:, s:], tcfg, mode="decode", state=st)
    _close(step, full[:, s:])


def test_mamba2_state_init_matches_jax_layout():
    jcfg, tcfg = _cfgs("zamba2-1.2b")
    jst = jssm.mamba2_init_state(jcfg, 3, jnp.float32)
    tst = tssm.mamba2_init_state(tcfg, 3, torch.float32, "cpu")
    assert {k: tuple(v.shape) for k, v in tst.items()} == {k: v.shape for k, v in jst.items()}
    jcfg, tcfg = _cfgs("xlstm-350m")
    jst = jssm.mlstm_init_state(jcfg, 3, jnp.bfloat16)
    tst = tssm.mlstm_init_state(tcfg, 3, torch.bfloat16, "cpu")
    assert {k: tuple(v.shape) for k, v in tst.items()} == {k: v.shape for k, v in jst.items()}
    assert tst["m"].dtype == torch.float32 and tst["c"].dtype == torch.bfloat16
    assert bool(torch.all(tst["m"] == -1e30))


def _layout(tree, path=""):
    """{path: (shape, dtype name)} of a nested dict of JAX or torch leaves."""
    if isinstance(tree, dict):
        return {k: v for name, sub in tree.items()
                for k, v in _layout(sub, f"{path}/{name}").items()}
    return {path: (tuple(tree.shape), str(tree.dtype).replace("torch.", ""))}


def test_init_layouts_match_jax():
    """Leaf names, shapes and dtypes of a block stacked on (2, 3) as JAX's
    init makes them (factor ranks from the same policy), and the conv
    kernel one draw repeated over the stack, as the reference's broadcast."""
    from repro_torch.core.decompose import Decomposer as TDecomposer
    from repro_torch.core.policy import LM_DEFAULT as T_LM_DEFAULT

    for arch in ARCHS:
        jcfg, tcfg = _cfgs(arch)
        jinit, tinit = ((jssm.mamba2_init, tssm.mamba2_init) if jcfg.family == "hybrid"
                        else (jssm.mlstm_init, tssm.mlstm_init))
        jp = jinit(Decomposer(POLICY, dtype=jnp.float32), jax.random.PRNGKey(0), "l", jcfg,
                   stack=(2, 3))
        tdec = TDecomposer(T_LM_DEFAULT.with_quantize(False).with_min_dim(16),
                           dtype=torch.float32, generator=torch.Generator().manual_seed(0))
        tp = tinit(tdec, "l", tcfg, stack=(2, 3))
        assert _layout(tp) == _layout(jp)
        if "conv1d" in tp:
            k = tp["conv1d"]["kernel"]
            assert torch.equal(k[0, 0], k[1, 2])
