"""K8 (flash attention) against its plain version, on a GPU (marked ``gpu``;
they skip without one: the kernel has no CPU mode).  No JAX here, so the
file runs on a machine that has only PyTorch:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_flash_gpu.py
"""

import dataclasses
import math

import numpy as np
import pytest
import torch

from repro_torch.kernels import ops, ref
from repro_torch.kernels.flash_attention import flash_attention

torch.set_num_threads(1)

# bf16, per query row: max |kernel - plain| / max |plain| in that row
# (chip_smoke.KERNEL_RTOL says why)
RTOL = 1e-2


def _need_gpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the kernel has no CPU mode")


def _qkv(seed, b, sq, sk, h, kv, d, q_scale=1.0, dv=None):
    """q, k, v with N(0, 1) entries (q times ``q_scale``): logits of unit
    variance after K8's D**-0.5.  v's head dim is ``dv`` (default D)."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, sq, h, d)) * q_scale
    k = rng.standard_normal((b, sk, kv, d))
    v = rng.standard_normal((b, sk, kv, dv or d))
    return [torch.from_numpy(a.astype(np.float32)).cuda().bfloat16() for a in (q, k, v)]


def _close(got, want):
    torch.cuda.synchronize()
    assert got.shape == want.shape and got.dtype == want.dtype
    diff = (got.float() - want.float()).abs()
    rel = (diff.amax(dim=-1) / want.float().abs().amax(dim=-1).clamp_min(1e-30)).max().item()
    assert math.isfinite(rel) and rel <= RTOL, rel


# (B, Sq, Sk, H, KV, D): ragged lengths, Sq < Sk, B > 1, GQA g 1 / 3 / 8;
# then Sq off every q tile (64 a warpgroup, 128 a unit), Sq under one tile with
# more keys, and g 3 with B 2, so the work walk crosses heads and batch rows
SHAPES = [
    (1, 1, 1, 15, 5, 64), (1, 17, 17, 15, 5, 64), (1, 64, 64, 4, 4, 64),
    (1, 130, 130, 6, 2, 64), (1, 2016, 2016, 15, 5, 64), (2, 100, 100, 6, 2, 128),
    (2, 77, 200, 8, 1, 64), (1, 512, 512, 64, 8, 128), (3, 33, 95, 3, 3, 128),
    (2, 200, 200, 15, 5, 64), (1, 50, 300, 6, 2, 64), (2, 1000, 1000, 9, 3, 64),
]


@pytest.mark.gpu
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("b,sq,sk,h,kv,d", SHAPES)
def test_gpu_flash_attention_matches_plain(b, sq, sk, h, kv, d, causal):
    _need_gpu()
    q, k, v = _qkv(sq + sk + h + d, b, sq, sk, h, kv, d)
    with torch.inference_mode():
        got = flash_attention(q, k, v, causal=causal)
        want = ref.flash_attention_fwd_ref(q, k, v, causal=causal)
    _close(got, want)


@pytest.mark.gpu
@pytest.mark.parametrize("b,sq,sk,h,kv,d", [(2, 200, 200, 15, 5, 64), (1, 2016, 2016, 15, 5, 64),
                                            (2, 300, 300, 16, 2, 128), (3, 70, 90, 4, 1, 64)])
def test_gpu_flash_attention_prescaled_multi_round_shapes_match_plain(b, sq, sk, h, kv, d):
    """Pre-scaled q undone by q_scale (as the model calls K8) at shapes whose
    units cross heads and batch rows, and at the serve shape, whose 240
    units take the persistent grid two rounds, causal and not."""
    _need_gpu()
    q, k, v = _qkv(b + sq + h, b, sq, sk, h, kv, d, q_scale=d ** -0.5)
    for causal in (True, False):
        with torch.inference_mode():
            got = flash_attention(q, k, v, causal=causal, q_scale=d ** 0.5)
            want = ref.flash_attention_fwd_ref(q, k, v, causal=causal, q_scale=d ** 0.5)
        _close(got, want)


# seamless-m4t-medium's prefill, 8 rows, 16 heads of 64 (KV 16): the
# encoder's self-attention over 1024 frames and the decoder's
# cross-attention (256 queries, 1024 frames), neither causal; the decoder's
# causal self-attention over 256 tokens
ENCDEC_SHAPES = [((8, 1024, 1024, 16, 16, 64), False), ((8, 256, 1024, 16, 16, 64), False),
                 ((8, 256, 256, 16, 16, 64), True)]


@pytest.mark.gpu
@pytest.mark.parametrize("shape,causal", ENCDEC_SHAPES)
def test_gpu_flash_attention_at_encdec_shapes_matches_plain(shape, causal):
    """Pre-scaled q as the model calls K8; the same bits on a second call."""
    _need_gpu()
    b, sq, sk, h, kv, d = shape
    q, k, v = _qkv(sq + sk + b, b, sq, sk, h, kv, d, q_scale=d ** -0.5)
    with torch.inference_mode():
        got = flash_attention(q, k, v, causal=causal, q_scale=d ** 0.5)
        want = ref.flash_attention_fwd_ref(q, k, v, causal=causal, q_scale=d ** 0.5)
        again = flash_attention(q, k, v, causal=causal, q_scale=d ** 0.5)
    _close(got, want)
    assert torch.equal(got, again)


@pytest.mark.gpu
@pytest.mark.parametrize("d", [64, 128])
def test_gpu_flash_attention_undoes_the_prescale_as_the_plain_version(d):
    """q pre-scaled by D**-0.5 (the projection), multiplied back by sqrt(D)
    in bf16 (``_flash_path``): at D = 128, sqrt(D) itself rounds in bf16."""
    _need_gpu()
    q, k, v = _qkv(d, 2, 150, 150, 6, 2, d, q_scale=d ** -0.5)
    with torch.inference_mode():
        got = flash_attention(q, k, v, causal=True, q_scale=d ** 0.5)
        want = ref.flash_attention_fwd_ref(q, k, v, causal=True, q_scale=d ** 0.5)
    _close(got, want)


# DeepSeek-V3's MLA prefill: q/k head dim 192 (nope 128 + rope 64), v head
# dim 128, every q head its own kv head (KV = H = 128): (B, Sq, Sk, H, KV),
# causal or not.  Causal 256 x 256 and 2048 x 2048, non-causal 256 x 2048,
# two batch rows, ragged Sq and Sk, Sq < Sk, few heads
MLA_SHAPES = [((8, 256, 256, 128, 128), True), ((1, 2048, 2048, 128, 128), True),
              ((1, 256, 2048, 128, 128), False), ((2, 100, 100, 6, 6), True),
              ((2, 77, 200, 4, 4), False), ((1, 1, 1, 2, 2), True), ((3, 130, 131, 3, 3), True),
              ((1, 17, 300, 4, 2), False)]


@pytest.mark.gpu
@pytest.mark.parametrize("shape,causal", MLA_SHAPES)
def test_gpu_flash_attention_mla_head_dims_match_plain(shape, causal):
    """K8 at (D, Dv) = (192, 128), q pre-scaled by 192**-0.5 and multiplied
    back as the model calls it; (B, Sq, H, 128) out; the same bits on a
    second call."""
    _need_gpu()
    b, sq, sk, h, kv = shape
    q, k, v = _qkv(sq + sk + b + h, b, sq, sk, h, kv, 192, q_scale=192 ** -0.5, dv=128)
    with torch.inference_mode():
        got = flash_attention(q, k, v, causal=causal, q_scale=192 ** 0.5)
        want = ref.flash_attention_fwd_ref(q, k, v, causal=causal, q_scale=192 ** 0.5)
        again = flash_attention(q, k, v, causal=causal, q_scale=192 ** 0.5)
    assert got.shape == (b, sq, h, 128)
    _close(got, want)
    assert torch.equal(got, again)


@pytest.mark.gpu
def test_gpu_flash_attention_mla_counts_dv_and_refuses_other_pairs():
    """The launch key carries Dv; (192, 192), (128, 64) and (64, 128) are
    refused, not run."""
    _need_gpu()
    q, k, v = _qkv(5, 1, 40, 40, 4, 4, 192, dv=128)
    flash_attention.launches_by_shape.clear()
    with torch.inference_mode():
        flash_attention(q, k, v, causal=True)
    torch.cuda.synchronize()
    assert dict(flash_attention.launches_by_shape) == {(1, 40, 40, 4, 4, 192, 128, True): 1}
    for d, dv in ((192, 192), (128, 64), (64, 128)):
        with pytest.raises(ValueError, match=f"head dim {d} with v head dim {dv}"):
            flash_attention(*_qkv(6, 1, 16, 16, 2, 2, d, dv=dv))


@pytest.mark.gpu
def test_gpu_flash_attention_ignores_future_kv_exactly():
    _need_gpu()
    q, k, v = _qkv(0, 2, 256, 256, 4, 2, 64)
    with torch.inference_mode():
        base = flash_attention(q, k, v, causal=True)
        k[:, 128:], v[:, 128:] = 999.0, -999.0  # strictly future for rows < 128
        poisoned = flash_attention(q, k, v, causal=True)
    torch.cuda.synchronize()
    assert torch.equal(base[:, :128], poisoned[:, :128])


@pytest.mark.gpu
def test_gpu_flash_attention_counts_launches_and_dispatches_to_the_kernel():
    _need_gpu()
    q, k, v = _qkv(3, 1, 40, 40, 6, 2, 64)
    flash_attention.launches = 0
    flash_attention.launches_by_shape.clear()
    with ops.capture_fallbacks() as fbs, torch.inference_mode():
        flash_attention(q, k, v, causal=True)
        ops.flash_attention_apply(q, k, v, causal=False)
        ref.flash_attention_fwd_ref(q, k, v)  # the plain version counts nothing
    torch.cuda.synchronize()
    assert fbs == []
    assert flash_attention.launches == 2
    assert dict(flash_attention.launches_by_shape) == {(1, 40, 40, 6, 2, 64, 64, True): 1,
                                                      (1, 40, 40, 6, 2, 64, 64, False): 1}


@pytest.mark.gpu
def test_gpu_flash_attention_raises_instead_of_falling_back():
    _need_gpu()
    q, k, v = _qkv(4, 1, 16, 16, 4, 2, 64)
    with pytest.raises(TypeError, match="bfloat16"):
        flash_attention(q.float(), k.float(), v.float())
    q96, k96, v96 = _qkv(4, 1, 16, 16, 4, 2, 96)
    with pytest.raises(ValueError, match="head dim 96"):
        flash_attention(q96, k96, v96)
    with pytest.raises(ValueError, match="operands on"):
        flash_attention(q, k.cpu(), v)
    with torch.enable_grad(), pytest.raises(RuntimeError, match="forward only"):
        flash_attention(q.detach().requires_grad_(True), k, v)
    with torch.enable_grad(), pytest.raises(RuntimeError, match="forward only"):
        ops.flash_attention_apply(q, k, v.detach().requires_grad_(True), causal=True)
    with pytest.raises(ValueError, match="multiple"):
        flash_attention(*_qkv(4, 1, 16, 16, 5, 2, 64))


@pytest.mark.gpu
def test_gpu_model_prefill_runs_k8_per_layer_and_matches_blockwise():
    """A small GQA model (D 64) on the card: ``attention_impl="flash"``
    launches K8 once a layer and agrees with the blockwise path."""
    _need_gpu()
    from repro_torch.configs import get_smoke_config
    from repro_torch.configs.base import LRDConfig, RunConfig, ShapeConfig
    from repro_torch.launch import steps
    from repro_torch.models import lm

    cfg = dataclasses.replace(get_smoke_config("smollm-360m"), head_dim=64, num_heads=6,
                              num_kv_heads=2, param_dtype="bfloat16",
                              compute_dtype="bfloat16")
    run = RunConfig(model=cfg, shape=ShapeConfig("s", 96, 1, "decode"),
                    lrd=LRDConfig(enabled=True, min_dim=16, rank_quantize=False,
                                  use_pallas_kernel=True))
    params, _ = steps.init_params(run, "cuda")
    toks = torch.randint(0, cfg.vocab_size, (2, 96), device="cuda",
                         generator=torch.Generator(device="cuda").manual_seed(0))
    flash_attention.launches = 0
    with torch.inference_mode():
        got, _, _ = lm.lm_apply(params, toks, dataclasses.replace(cfg, attention_impl="flash"),
                                mode="full", policy=True)
        n = flash_attention.launches
        want, _, _ = lm.lm_apply(params, toks, dataclasses.replace(cfg, attention_impl="blockwise"),
                                 mode="full", policy=True)
    torch.cuda.synchronize()
    assert n == cfg.num_layers and flash_attention.launches == n
    err = (got - want).abs().max().item()
    assert err <= 5e-2 * want.abs().max().item()  # chip_smoke.PATH_RTOL
