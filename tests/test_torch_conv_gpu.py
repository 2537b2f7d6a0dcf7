"""The ResNet's conv path on a GPU against the port's own CPU run (marked
``gpu``; skips without one).  No JAX here, so the file runs on a machine
that has only PyTorch:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_conv_gpu.py

``conv_apply`` (every branch: dense 1x1 / 3x3 / 7x7, the Tucker triple, the
SVD pair; strides 1 and 2; odd and even sizes, where XLA's SAME padding is
asymmetric; the stem's and a stage's real shapes), forward and backward
(the backward under ``resnet.fp32_convs()``, as a train step runs it), and
the max-pool, with cuDNN's TF32 switched on around the call: ``conv_apply``
must still compute in float32.
"""

import numpy as np
import pytest
import torch

from repro_torch.models import resnet

torch.set_num_threads(1)

# max |cuda - cpu| / max |cpu| of the output and of each gradient, float32
# both: cuDNN's float32 algorithms stay within ~2e-5 of a float64 conv on
# the H100 (Winograd-like weight gradients the worst), oneDNN's within
# ~4e-6; TF32 operands (10-bit mantissas) miss by 3e-4 to 9e-4
CONV_RTOL = 1e-4

BRANCHES = ["dense1", "dense3", "dense7", "tucker", "svd"]
# (branch, (batch, H, W, C, S, r)): every branch at small odd / even sizes
# and at a stage-1 conv's shape (56 x 56, 128 channels, Eq.-5 r1 77), and
# the stem (7x7, 3 -> 64 channels on 224).  No 1x1 conv reads 3 channels:
# PyTorch's CPU backward of a strided 1x1 conv on a channels_last 3-channel
# 224 x 224 input crashes (torch 2.11 and 2.13), and no ResNet has one
CASES = [(branch, shape) for branch in BRANCHES
         for shape in [(2, 7, 7, 6, 10, 4), (2, 8, 8, 6, 10, 4), (2, 7, 8, 6, 10, 4),
                       (2, 56, 56, 128, 128, 77)]] + [("dense7", (2, 224, 224, 3, 64, 3))]


def _need_gpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")


def _params(branch, rng, c, s, r):
    def w(*shape):
        return torch.from_numpy((rng.standard_normal(shape) / np.sqrt(shape[-2]))
                                .astype(np.float32))

    p = {"dense1": lambda: {"kernel": w(1, 1, c, s)},
         "dense3": lambda: {"kernel": w(3, 3, c, s)},
         "dense7": lambda: {"kernel": w(7, 7, c, s)},
         "tucker": lambda: {"first": w(c, r), "core": w(3, 3, r, r), "last": w(r, s)},
         "svd": lambda: {"u": w(c, r), "v": w(r, s)}}[branch]()
    p["scale"] = torch.from_numpy(rng.uniform(0.5, 1.5, s).astype(np.float32))
    p["bn_bias"] = torch.from_numpy(rng.standard_normal(s).astype(np.float32))
    return p


def _rel(got, want):
    return ((got.cpu().double() - want.double()).abs().max()
            / want.double().abs().max()).item()


@pytest.mark.gpu
@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("branch,shape", CASES)
def test_gpu_conv_apply_matches_cpu(branch, shape, stride):
    _need_gpu()
    b, h, w, c, s, r = shape
    rng = np.random.default_rng([BRANCHES.index(branch), stride, h, w, c])
    p = _params(branch, rng, c, s, r)
    x = torch.from_numpy(rng.standard_normal((b, h, w, c)).astype(np.float32))
    dy = torch.from_numpy(rng.standard_normal(
        (b, -(-h // stride), -(-w // stride), s)).astype(np.float32))

    def run(device):
        leaves = {k: v.to(device).requires_grad_() for k, v in p.items()}
        xx = x.to(device).requires_grad_()
        y = resnet.conv_apply(leaves, xx, stride)
        with resnet.fp32_convs():
            grads = torch.autograd.grad(y, [xx, *leaves.values()], dy.to(device))
        return y.detach(), dict(zip(["x", *leaves], grads))

    want, want_grads = run("cpu")
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True
    try:
        got, got_grads = run("cuda")
        assert torch.backends.cudnn.allow_tf32  # the caller's setting is back
    finally:
        torch.backends.cudnn.allow_tf32 = prev
    assert got.shape == want.shape and got.dtype == torch.float32 and got.is_cuda
    assert _rel(got, want) <= CONV_RTOL
    for name, g in got_grads.items():
        assert _rel(g, want_grads[name]) <= CONV_RTOL, name


@pytest.mark.gpu
@pytest.mark.parametrize("hw", [(8, 8), (7, 7), (6, 9), (112, 112), (1, 1)])
def test_gpu_max_pool_matches_cpu(hw):
    """All-negative inputs: padding with 0 instead of -inf would show."""
    _need_gpu()
    x = -torch.from_numpy(np.abs(np.random.default_rng(sum(hw)).standard_normal(
        (2, *hw, 64))).astype(np.float32)) - 1.0
    want = resnet.max_pool_same(x)
    got = resnet.max_pool_same(x.cuda())
    assert torch.equal(got.cpu(), want)
