"""The port's roofline (``repro_torch.analysis.roofline``) against the JAX
package's: the v5e arithmetic (``dtype_bytes``, the block-triple model,
``model_flops_per_device``, ``roofline_terms``) equal exactly on a grid of
inputs; ``kernel_cost`` equal to the bytes and operations each kernel row
of ``chip_smoke.py`` was bounded by before it read them from here (that
arithmetic is spelled out below) at every row the script checks; the H100
specs and the port's candidate model (float32 at its own peak, the
shared-memory prune)."""

import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke as cs
from repro.analysis import hlo as jhlo
from repro.analysis import roofline as jroof
from repro_torch.analysis import roofline
from repro_torch.analysis.cost import StepCost
from repro_torch.kernels import autotune
from repro_torch.kernels import lowrank_matmul as k1

torch.set_num_threads(1)

OPS = ("lowrank_fwd", "lowrank_dx", "lowrank_du", "lowrank_dv", "lowrank_ffn", "flash")
DTYPES = [("float32", jnp.float32, torch.float32), ("bfloat16", jnp.bfloat16, torch.bfloat16),
          ("int8", jnp.int8, torch.int8), ("float16", jnp.float16, torch.float16),
          ("float64", np.float64, torch.float64), ("uint8", jnp.uint8, torch.uint8)]
BLOCKS = list(itertools.product((8, 128, 256, 512), (128, 512), (128, 256)))
SHAPES = [(8, 960, 240, 960), (256, 512, 64, 256), (2048, 2560, 349, 960), (300, 512, 17, 96)]


@pytest.mark.parametrize("name,jdt,tdt", DTYPES)
def test_dtype_bytes(name, jdt, tdt):
    want = jroof.dtype_bytes(jnp.dtype(jdt))
    assert roofline.dtype_bytes(tdt) == roofline.dtype_bytes(name) == want


@pytest.mark.parametrize("op", OPS)
def test_block_model_equals_the_references(op):
    for (bm, bk, bn), r, (_, jdt, tdt) in itertools.product(BLOCKS, (16, 128, 349), DTYPES[:3]):
        for db in (True, False):
            assert (roofline.kernel_vmem_bytes(op, bm, bk, bn, r, tdt, double_buffered=db)
                    == jroof.kernel_vmem_bytes(op, bm, bk, bn, r, jnp.dtype(jdt),
                                               double_buffered=db))
        for m, c, rr, s in SHAPES:
            assert (roofline.kernel_candidate_time(op, m, c, rr, s, bm, bk, bn, tdt)
                    == jroof.kernel_candidate_time(op, m, c, rr, s, bm, bk, bn, jnp.dtype(jdt)))


@pytest.mark.parametrize("op", OPS)
@pytest.mark.parametrize("m,c,r,s", SHAPES)
def test_prune_candidates_equal_the_references(op, m, c, r, s):
    for _, jdt, tdt in DTYPES[:3]:
        assert (roofline.prune_candidates(op, m, c, r, s, tdt, BLOCKS)
                == jroof.prune_candidates(op, m, c, r, s, jnp.dtype(jdt), BLOCKS))


@pytest.mark.parametrize("kind", ["train", "infer"])
def test_model_flops_per_device(kind):
    for n, tokens, devices in itertools.product((3.6e8, 7.2e10, 1.3e9), (8, 2048, 1 << 20),
                                                (1, 4, 256)):
        assert (roofline.model_flops_per_device(n, tokens, devices, kind=kind)
                == jroof.model_flops_per_device(n, tokens, devices, kind=kind))


@pytest.mark.parametrize("flops,nbytes,coll", [
    (4.2e15, 3.1e12, {}), (1.0e9, 7.3e11, {"all-reduce": 2.0e9, "all-gather": 5.0e8}),
    (0.0, 1.0, {}), (6.0e12, 0.0, {"reduce-scatter": 1.0})])
@pytest.mark.parametrize("model_flops", [0.0, 3.3e12, 9.9e15])
def test_roofline_terms_equal_the_references(flops, nbytes, coll, model_flops):
    jc = jhlo.HloCost(flops=flops, bytes=nbytes, collective_bytes=dict(coll))
    tc = StepCost(flops=flops, bytes=nbytes, collective_bytes=dict(coll),
                  flops_by_dtype={"bfloat16": flops} if flops else {})
    want = jroof.roofline_terms(jc, model_flops=model_flops)
    got = roofline.roofline_terms(tc, model_flops=model_flops)
    for k in ("compute_s", "memory_s", "collective_s", "model_flops", "hlo_flops",
              "useful_ratio", "collective_breakdown", "dominant", "step_s",
              "roofline_fraction"):
        assert getattr(got, k) == getattr(want, k), k


def test_h100_specs_and_float32_pricing():
    h = roofline.H100_SPECS
    assert (h.peak_flops, h.int8_flops, h.f32_flops, h.hbm_bw, h.ici_bw, h.hbm_bytes) == (
        989e12, 1979e12, 67e12, 3.35e12, 450e9, 80e9)
    assert h.vmem_bytes == k1.SMEM_MAX == 232448
    cost = StepCost(flops=3e12, flops_by_dtype={"bfloat16": 1e12, "float32": 1e12, "int8": 1e12})
    assert roofline.compute_seconds(cost, h) == 1e12 / 989e12 + 1e12 / 67e12 + 1e12 / 1979e12
    rl = roofline.roofline_terms(cost, model_flops=1e12, specs=h)
    # the fraction uses the specs it was given, not v5e's
    assert rl.roofline_fraction == (1e12 / 989e12) / rl.step_s


# --------------------------------------------------------------------------
# kernel_cost: chip_smoke.py's bound arithmetic, at its rows
# --------------------------------------------------------------------------

def _chip_smoke_lowrank(name, d):
    """(ops, bytes) as chip_smoke.kernel_case computed them."""
    m, c, r = d["M"], d["C"], d["r"]
    if name == "lowrank_gated_ffn":
        f = d["F"]
        return 2 * 2 * (m * c * r + m * r * f), 2 * (m * c + 2 * c * r + 2 * r * f + m * f)
    s = d["S"]
    return 2 * m * c * r + 2 * m * r * s, 2 * (m * c + c * r + r * s + m * s)


def _chip_smoke_int8(name, d):
    """(ops, bytes) as chip_smoke.int8_kernel_case computed them."""
    m, c, s = d["M"], d["C"], d["S"]
    fused = name in cs.INT8_FUSED
    xbytes, ybytes = (2 * m * c, 2 * m * s) if fused else (m * c, 4 * m * s)
    if name == "int8_matmul":
        return 2 * m * c * s, xbytes + c * s + ybytes
    if name == "int8_linear":
        return 2 * m * c * s, xbytes + c * s + 4 * s + ybytes
    r = d["r"]
    return 2 * m * c * r + 2 * m * r * s, xbytes + c * r + 4 * r + r * s + 4 * s + ybytes


def _chip_smoke_flash(d):
    """(ops, bytes) as chip_smoke.flash_kernel_case computed them."""
    b, sq, sk, h, kv, dh, dv, causal = cs.shape_key("flash_attention", d)
    visible = sum(min(i + 1, sk) for i in range(sq)) if causal else sq * sk
    return (2 * b * h * (dh + dv) * visible,
            2 * (b * sq * h * (dh + dv) + b * sk * kv * (dh + dv)))


def _lowrank_rows():
    rows = (cs.kernel_shapes() + cs.moe_kernel_shapes() + cs.ssm_kernel_shapes()
            + cs.encdec_kernel_shapes() + cs.vlm_kernel_shapes() + cs.mla_kernel_shapes()
            + list(cs.RANK_EDGE_SHAPES) + list(cs.RANK_GATE_SHAPES)
            + list(cs.ENCDEC_EXTRA_SHAPES))
    return [sd for i, sd in enumerate(rows) if sd not in rows[:i]]


def _int8_rows():
    out = []
    for fused, key in (list(cs.INT8_DEFAULT_SHAPES) + list(cs.INT8_WIDE_SHAPES)
                       + list(cs.INT8_CEILING_SHAPES)):
        for name in (fused, cs.INT8_FUSED[fused]):
            d = (dict(M=key[0], C=key[1], S=key[2]) if name in ("int8_matmul", "int8_linear")
                 else dict(M=key[0], C=key[1], r=key[2], S=key[3]))
            out.append((name, d))
    return out


def _flash_rows():
    return ([cs.FLASH_SERVE_SHAPE] + cs.FLASH_EXTRA + cs.DS_FLASH_EXTRA
            + [cs.flash_dims(k) for k in list(cs.ED_FLASH) + list(cs.VLM_FLASH)
               + list(cs.DS_FLASH)])


def test_kernel_cost_equals_chip_smoke_lowrank_rows():
    rows = _lowrank_rows()
    assert len(rows) > 200
    for name, d in rows:
        assert roofline.kernel_cost(name, d) == _chip_smoke_lowrank(name, d), (name, d)


def test_kernel_cost_equals_chip_smoke_int8_rows():
    rows = _int8_rows()
    assert rows
    for name, d in rows:
        assert roofline.kernel_cost(name, d) == _chip_smoke_int8(name, d), (name, d)


def test_kernel_cost_equals_chip_smoke_flash_rows():
    for d in _flash_rows():
        dims = cs.flash_dims(cs.shape_key("flash_attention", d))
        assert roofline.kernel_cost("flash_attention", dims) == _chip_smoke_flash(d), d


def test_kernel_cost_unequal_ffn_ranks():
    """K5's launch key carries both branch ranks; with rg = ru it is the
    row arithmetic, and each branch adds its own."""
    d = dict(M=8, C=960, rg=349, ru=349, F=2560)
    assert roofline.kernel_cost("lowrank_gated_ffn", d) == _chip_smoke_lowrank(
        "lowrank_gated_ffn", dict(M=8, C=960, r=349, F=2560))
    ops, nbytes = roofline.kernel_cost("lowrank_gated_ffn", dict(M=8, C=960, rg=100, ru=200,
                                                                 F=2560))
    assert ops == 2 * (8 * 960 * 300 + 8 * 300 * 2560)
    assert nbytes == 2 * (8 * 960 + 960 * 300 + 300 * 2560 + 8 * 2560)


# --------------------------------------------------------------------------
# the port's candidate model
# --------------------------------------------------------------------------

@pytest.mark.parametrize("op", OPS)
@pytest.mark.parametrize("m", [8, 128, 320, 2048])
def test_prune_choices_orders_by_predicted_time(op, m):
    c, r, s = (15, 64, 2016) if op == "flash" else (960, 349, 2560)
    cands = autotune.candidates(op, m, c, r, s, 132)
    pruned = roofline.prune_choices(op, m, c, r, s, cands)
    assert pruned and set(pruned) <= set(cands)
    times = [roofline.choice_time(op, m, c, r, s, ch) for ch in pruned]
    assert times == sorted(times) and all(t > 0 for t in times)
    assert autotune.hand_choice(op, m, c, r, s, 132) in pruned


def test_prune_choices_drops_what_shared_memory_cannot_hold():
    """The wrappers' shared-memory sizes decide: every plan the kernels
    take fits the H100's 227 KB a block (they walk the rank in pieces), so
    the prune shows on a part with less: K5's decode design at r 4096 with
    64-column tiles of S needs 184.5 KB in phase 2, with 16-column tiles
    less."""
    import dataclasses

    wide = autotune.Choice("decode", (8, 512, 1, 64, 64))
    narrow = autotune.Choice("decode", (8, 512, 1, 64, 16))
    wide_b, narrow_b = (k1.decode_out_smem(16, 4096, w2, 2) for w2 in (64, 16))
    assert narrow_b < wide_b <= k1.SMEM_MAX
    both = roofline.prune_choices("lowrank_ffn", 8, 4096, 4096, 4096, [wide, narrow])
    assert set(both) == {wide, narrow}
    small = dataclasses.replace(roofline.H100_SPECS, vmem_bytes=wide_b - 1)
    assert roofline.prune_choices("lowrank_ffn", 8, 4096, 4096, 4096, [wide, narrow],
                                  specs=small) == [narrow]
