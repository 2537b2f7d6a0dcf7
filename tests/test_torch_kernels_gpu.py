"""The CUDA kernels against their plain versions, on a GPU (marked ``gpu``;
they skip without one: the kernels have no CPU mode).  No JAX here, so the
file runs on a machine that has only PyTorch:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_kernels_gpu.py
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels import ref
from repro_torch.kernels.lowrank_ffn import lowrank_gated_ffn
from repro_torch.kernels.lowrank_matmul import lowrank_matmul

torch.set_num_threads(1)

# max |kernel - plain| / max |plain| in bf16; chip_smoke.KERNEL_RTOL says why
K1_RTOL, K5_RTOL = 1e-2, 2e-2


def _mats(seed, *shapes):
    rng = np.random.default_rng(seed)
    out = [rng.standard_normal(shapes[0]).astype(np.float32)]
    for shape in shapes[1:]:
        out.append((rng.standard_normal(shape) / np.sqrt(shape[0])).astype(np.float32))
    return [torch.from_numpy(a).cuda().bfloat16() for a in out]


# --------------------------------------------------------------------------
# On the card: the CUDA kernels against their plain versions
# --------------------------------------------------------------------------

# the serving slice's (C, r, S) of K1 and (C, r, F) of K5, plus ragged edges
GPU_K1 = [(960, 240, 960), (960, 120, 320), (2560, 349, 960), (70, 5, 33)]
GPU_K5 = [(960, 349, 2560), (70, 17, 33)]


def _need_gpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the kernels have no CPU mode")


@pytest.mark.gpu
@pytest.mark.parametrize("m", [1, 8, 128])
@pytest.mark.parametrize("c,r,s", GPU_K1)
def test_gpu_lowrank_matmul_matches_plain(m, c, r, s):
    _need_gpu()
    x, u, v = _mats(m + c, (m, c), (c, r), (r, s))
    with torch.inference_mode():
        got, want = lowrank_matmul(x, u, v), ref.lowrank_matmul_ref(x, u, v)
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs().max().item()
    assert err <= K1_RTOL * want.float().abs().max().item()


@pytest.mark.gpu
@pytest.mark.parametrize("m", [1, 8, 128])
@pytest.mark.parametrize("c,r,f", GPU_K5)
def test_gpu_lowrank_gated_ffn_matches_plain(m, c, r, f):
    _need_gpu()
    args = _mats(m + c, (m, c), (c, r), (r, f), (c, r), (r, f))
    with torch.inference_mode():
        got, want = lowrank_gated_ffn(*args), ref.lowrank_gated_ffn_ref(*args)
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs().max().item()
    assert err <= K5_RTOL * want.float().abs().max().item()


@pytest.mark.gpu
def test_gpu_wrappers_raise_instead_of_falling_back():
    _need_gpu()
    x = torch.zeros(4, 8, device="cuda")
    u, v = torch.zeros(8, 2, device="cuda"), torch.zeros(2, 3, device="cuda")
    with pytest.raises(TypeError, match="bfloat16"):
        lowrank_matmul(x, u, v)
    with pytest.raises(ValueError, match="not contiguous"):
        lowrank_matmul(x.bfloat16(), u.bfloat16().t().contiguous().t(), v.bfloat16())


@pytest.mark.gpu
@pytest.mark.parametrize("m", [8, 40])
def test_gpu_kernels_take_unaligned_operands(m):
    """Operands that do not start on a 16-byte boundary (a layer view of a
    stacked tensor can) take the element-load path and agree all the same."""
    _need_gpu()
    c, r, s = 96, 24, 80

    def shifted(t):
        buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
        view = buf[1:].view(t.shape)
        view.copy_(t)
        return view

    x, u, v = (shifted(t) for t in _mats(m, (m, c), (c, r), (r, s)))
    gu, gv = (shifted(t) for t in _mats(m + 1, (1,), (c, r), (r, s))[1:])
    with torch.inference_mode():
        got, want = lowrank_matmul(x, u, v), ref.lowrank_matmul_ref(x, u, v)
        hg, hw = lowrank_gated_ffn(x, gu, gv, u, v), ref.lowrank_gated_ffn_ref(x, gu, gv, u, v)
    torch.cuda.synchronize()
    for a, b, rtol in ((got, want, K1_RTOL), (hg, hw, K5_RTOL)):
        err = (a.float() - b.float()).abs().max().item()
        assert err <= rtol * b.float().abs().max().item()
