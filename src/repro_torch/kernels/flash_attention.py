"""K8: flash-attention forward on the H100.

The CUDA C++ kernel is ``csrc/flash_attention.cu`` (its source note says
which TPU kernel it replaces, what bounds it and how the design answers
that).  :func:`flash_attention` takes CPU tensors through the plain version
(``ref.flash_attention_fwd_ref``) and CUDA tensors through the kernel, and
raises on anything the kernel does not take (float32, a head dim other than
64 or 128, mixed devices, an operand that requires grad); it never falls
back.  ``flash_attention.launches`` counts kernel launches, and
``flash_attention.launches_by_shape`` counts them by ``(B, Sq, Sk, H, KV, D,
causal)``.

Its work order is plain Python here, mirrored by the kernel: a unit is
``UNIT_ROWS`` q rows of one head (each of the kernel's two consumer
warpgroups 64 of them), units go heaviest first (:func:`flash_units`), and
a grid of at most one wave (:func:`flash_grid`) walks them in a snake
(:func:`flash_plan`).

The kernel is forward only, as the TPU kernel is: it has no backward, and
``jax.grad`` through the reference's kernel fails too.
"""

from __future__ import annotations

import ctypes
from collections import Counter

import torch

from repro_torch.kernels import build, ref
from repro_torch.kernels.lowrank_matmul import check_cuda_operands, raise_on_error

__all__ = ["flash_attention", "HEAD_DIMS", "flash_unit_count", "flash_units", "flash_grid",
           "flash_plan"]

HEAD_DIMS = (64, 128)  # the D the kernel is built for (every dense arch's head dim)
# csrc/flash_attention.cu: q rows of a consumer warpgroup (kRows), keys of
# a kv tile (kBK), and q rows of a unit (kNW warpgroups of kRows)
ROWS, KV_TILE = 64, 64
UNIT_ROWS = 2 * ROWS


def flash_unit_count(b: int, sq: int, h: int) -> int:
    """Units of work of a call: ``UNIT_ROWS`` q rows of one (batch row, q
    head)."""
    return b * h * -(-sq // UNIT_ROWS)


def flash_units(b: int, sq: int, sk: int, h: int, kv: int, causal: bool) -> list:
    """Every unit of work in the kernel's order, heaviest first: (batch row,
    q head, first q row of each warpgroup, kv head, kv tiles loaded).  q
    tiles go from the last (under ``causal`` the last rows see the most
    keys), each over every (batch row, head)."""
    nq, nk_all = -(-sq // UNIT_ROWS), -(-sk // KV_TILE)
    out = []
    for p in range(flash_unit_count(b, sq, h)):
        qt = nq - 1 - p // (b * h)
        bb, head = divmod(p % (b * h), h)
        last = min(qt * UNIT_ROWS + UNIT_ROWS, sq) - 1
        nk = min(nk_all, last // KV_TILE + 1) if causal else nk_all
        q0s = [qt * UNIT_ROWS + w * ROWS for w in range(UNIT_ROWS // ROWS)]
        out.append((bb, head, q0s, head // (h // kv), nk))
    return out


def flash_grid(units: int, sms: int) -> int:
    """CTAs of a call: a persistent grid of at most one wave."""
    return min(units, sms)


def flash_plan(units: int, sms: int) -> list:
    """The unit positions each CTA takes, in order: the grid's G CTAs walk
    the heaviest-first order in a snake (CTA c takes c, 2G - 1 - c,
    2G + c, ...), so each round's light end meets the last round's heavy
    one."""
    grid = flash_grid(units, sms)
    plan = []
    for c in range(grid):
        mine, k = [], 0
        while True:
            pos = k * grid + (grid - 1 - c if k % 2 else c)
            if pos >= units:
                break
            mine.append(pos)
            k += 1
        plan.append(mine)
    return plan


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, q_scale: float = 1.0) -> torch.Tensor:
    """q (B, Sq, H, D), k/v (B, Sk, KV, D) -> (B, Sq, H, D) in q's dtype.

    q head h attends with kv head h // (H / KV).  q is first multiplied by
    ``q_scale`` in its own dtype, then the logits by D**-0.5 in float32
    (``ref.flash_attention_fwd_ref`` spells the arithmetic out).  Under
    ``causal`` query i sees keys 0..i."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise RuntimeError(
            "flash attention is forward only: the reference's flash kernel "
            "(repro/kernels/flash_attention.py) has no backward, so there is "
            "nothing to differentiate through; train with attention_impl "
            "'blockwise' or 'dense'")
    if q.device.type == "cpu":
        return ref.flash_attention_fwd_ref(q, k, v, causal=causal, q_scale=q_scale)
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"flash_attention: want q (B,Sq,H,D), k and v (B,Sk,KV,D); got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    b, sq, h, d = q.shape
    sk, kvh = k.shape[1], k.shape[2]
    if k.shape[0] != b or k.shape[3] != d:
        raise ValueError(f"flash_attention: k {tuple(k.shape)} does not match q "
                         f"{tuple(q.shape)}")
    if d not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head dim {d} not in {HEAD_DIMS}")
    if kvh == 0 or h % kvh:
        raise ValueError(f"flash_attention: {h} q heads are not a multiple of {kvh} "
                         f"kv heads")
    if sk == 0:
        raise ValueError("flash_attention: no keys (Sk = 0)")
    check_cuda_operands("flash_attention", (q, k, v))
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("flash_attention: q, k and v must start on a 16-byte boundary "
                         "(the kernel reads them by TMA)")
    o = torch.empty((b, sq, h, d), dtype=q.dtype, device=q.device)
    if o.numel() == 0:
        return o
    sms = torch.cuda.get_device_properties(q.device).multi_processor_count
    grid = flash_grid(flash_unit_count(b, sq, h), sms)
    # the multiplier as q's dtype holds it, as JAX's weakly typed q * sqrt(D)
    q_mul = float(torch.tensor(q_scale, dtype=q.dtype))
    lib = build.load("flash_attention")
    fn = lib.repro_flash_attention
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 8
                   + [ctypes.c_float, ctypes.c_float, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    code = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), b, sq, sk, h, kvh, d,
              int(causal), grid, q_mul, d ** -0.5,
              torch.cuda.current_stream(q.device).cuda_stream)
    raise_on_error("flash_attention", lib, code)
    flash_attention.launches += 1
    flash_attention.launches_by_shape[(b, sq, sk, h, kvh, d, bool(causal))] += 1
    return o


flash_attention.launches = 0
flash_attention.launches_by_shape = Counter()
