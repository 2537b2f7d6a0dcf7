"""Checkpoints in the on-disk format of ``repro/checkpoint/store.py``, so
either package resumes the other's runs.

Layout (one directory per step)::

    ckpt_dir/step_00000120/
        manifest.json     tree structure, shapes, dtypes, step, extra state
        leaf_00000.npy    one file per leaf (host copy)
        .complete         commit marker (written in a tmp dir, then renamed)

Tree keys are ``/``-joined dict keys, ``__i`` for a sequence index and
``__empty`` for an empty tuple; a ``None`` hole is ``{"kind": "none"}``.
bfloat16 leaves are written as the JAX package writes them: 2-byte raw
records under the ``.npy`` descr ``'<V2'`` with ``"dtype": "bfloat16"``
in the manifest (no ``ml_dtypes`` needed), and read back through the
manifest's dtype.  Saves are atomic (tmp dir + rename) and the newest
``keep`` complete checkpoints are retained.

The train state is stored MERGED (``pack_phased_state``): params plus the
full per-group moments and the freezing phase in ``extra``; a restore
re-partitions for the saved phase (``unpack_phased_state``).
"""

from __future__ import annotations

import json
import os
import shutil
from pathlib import Path
from typing import Any, Dict, Optional

import numpy as np
import torch

from repro_torch.core import freezing, rank_adapt

__all__ = ["pack_phased_state", "unpack_phased_state", "live_rank_map", "save_checkpoint",
           "load_checkpoint", "latest_checkpoint", "CheckpointManager"]


def pack_phased_state(state, parked) -> Dict[str, Any]:
    """``(TrainState, parked (mu, nu))`` -> the merged plain dict
    ``{"params", "step", "mu", "nu"}`` with no ``None`` holes."""
    trainable, frozen, opt = state[:3]
    step, mu, nu = opt
    full_mu, full_nu = freezing.merge_moments((mu, nu), parked)
    return {"params": freezing.merge(trainable, frozen), "step": step,
            "mu": full_mu, "nu": full_nu}


def live_rank_map(state) -> Dict[str, int]:
    """``{factor-group path: rank}`` of a packed state's (or a param tree's)
    factor groups — the manifest's ``extra["rank_map"]``, as
    ``rank_adapt.live_rank_map`` reads it."""
    params = state["params"] if isinstance(state, dict) and "params" in state else state
    return rank_adapt.live_rank_map(params)


def unpack_phased_state(saved: Dict[str, Any], phase: int,
                        expect_rank_map: Optional[Dict[str, int]] = None):
    """Inverse of :func:`pack_phased_state` for ``phase``: returns
    ``((trainable, frozen, (step, mu, nu)), parked)``.  ``expect_rank_map``
    (the manifest's) must agree with the restored factor shapes."""
    if not isinstance(saved, dict) or "params" not in saved:
        raise ValueError("unpack_phased_state: checkpoint is not in the phased dict "
                         "format {'params', 'step', 'mu', 'nu'}")
    if expect_rank_map:
        got = live_rank_map(saved)
        expect = {p: int(r) for p, r in expect_rank_map.items()}
        diff = {p: (got.get(p), r) for p, r in expect.items() if got.get(p) != r}
        if diff:
            raise ValueError(f"unpack_phased_state: restored factor ranks disagree with "
                             f"the manifest rank map at {diff} (got, expected)")
    trainable, frozen = freezing.partition(saved["params"], phase)
    (mu, nu), parked = freezing.partition_moments((saved["mu"], saved["nu"]), phase)
    return (trainable, frozen, (saved["step"], mu, nu)), parked


def _flatten(tree: Any, prefix: str = "") -> Dict[str, Any]:
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_flatten(v, f"{prefix}/{k}" if prefix else str(k)))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(_flatten(v, f"{prefix}/__{i}" if prefix else f"__{i}"))
        if len(tree) == 0:
            out[(prefix + "/__empty") if prefix else "__empty"] = None
    else:
        out[prefix] = tree
    return out


def _unflatten(flat: Dict[str, Any]) -> Any:
    root: Dict[str, Any] = {}
    for key, val in flat.items():
        parts = key.split("/")
        node = root
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = val

    def fix(node):
        if not isinstance(node, dict):
            return node
        if node and all(k.startswith("__") for k in node):
            if "__empty" in node:
                return ()
            items = sorted(node.items(), key=lambda kv: int(kv[0][2:]))
            return tuple(fix(v) for _, v in items)
        return {k: fix(v) for k, v in node.items()}

    return fix(root)


def _to_host(leaf: Any) -> Any:
    """A tensor -> a CPU copy of it (bf16 kept; a CPU tensor is copied too,
    since a donated train step updates the state in place); numpy and
    scalars pass."""
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().to("cpu", copy=True)
    return leaf


def _save_leaf(path: Path, leaf: Any) -> Dict[str, Any]:
    if isinstance(leaf, torch.Tensor) and leaf.dtype == torch.bfloat16:
        raw = leaf.contiguous().view(torch.int16).numpy()
        with open(path, "wb") as f:
            np.lib.format.write_array_header_1_0(
                f, {"descr": "<V2", "fortran_order": False, "shape": tuple(raw.shape)})
            f.write(raw.tobytes())
        return {"shape": list(raw.shape), "dtype": "bfloat16"}
    arr = leaf.numpy() if isinstance(leaf, torch.Tensor) else np.asarray(leaf)
    np.save(path, arr)
    return {"shape": list(arr.shape), "dtype": str(arr.dtype)}


def _load_leaf(path: Path, dtype: str) -> torch.Tensor:
    arr = np.load(path)
    if dtype == "bfloat16":
        return torch.from_numpy(np.ascontiguousarray(arr).view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(np.ascontiguousarray(arr))


def save_checkpoint(ckpt_dir: str | Path, step: int, state: Any,
                    extra: Optional[Dict] = None, keep: int = 3) -> Path:
    ckpt_dir = Path(ckpt_dir)
    ckpt_dir.mkdir(parents=True, exist_ok=True)
    final = ckpt_dir / f"step_{step:08d}"
    tmp = ckpt_dir / f".tmp-step_{step:08d}"
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir(parents=True)
    manifest = {"step": step, "extra": extra or {}, "leaves": {}}
    for i, (key, leaf) in enumerate(_flatten(state).items()):
        if leaf is None:
            manifest["leaves"][key] = {"kind": "none"}
            continue
        fname = f"leaf_{i:05d}.npy"
        meta = _save_leaf(tmp / fname, _to_host(leaf))
        manifest["leaves"][key] = {"kind": "array", "file": fname, **meta}
    (tmp / "manifest.json").write_text(json.dumps(manifest))
    (tmp / ".complete").write_text("ok")
    if final.exists():
        shutil.rmtree(final)
    os.replace(tmp, final)
    complete = sorted(d for d in ckpt_dir.glob("step_*") if (d / ".complete").exists())
    for old in complete[:-keep]:
        shutil.rmtree(old, ignore_errors=True)
    return final


def latest_checkpoint(ckpt_dir: str | Path) -> Optional[Path]:
    ckpt_dir = Path(ckpt_dir)
    if not ckpt_dir.exists():
        return None
    complete = sorted(d for d in ckpt_dir.glob("step_*") if (d / ".complete").exists())
    return complete[-1] if complete else None


def load_checkpoint(path: str | Path, device="cpu"):
    """Returns ``(state, step, extra)`` with every leaf a tensor on ``device``."""
    path = Path(path)
    manifest = json.loads((path / "manifest.json").read_text())
    flat: Dict[str, Any] = {}
    for key, meta in manifest["leaves"].items():
        flat[key] = (None if meta["kind"] == "none"
                     else _load_leaf(path / meta["file"], meta["dtype"]).to(device))
    return _unflatten(flat), manifest["step"], manifest["extra"]


class CheckpointManager:
    """Auto-resume, periodic save and a SIGTERM-triggered final save.

    Saves are asynchronous: the device -> host copy happens inline (so the
    next step may replace the device tensors), the file writes run on a
    background thread, and the next save (or :meth:`close`) joins it.
    """

    def __init__(self, ckpt_dir: str | Path, save_every: int = 100, keep: int = 3):
        import concurrent.futures

        self.dir = Path(ckpt_dir)
        self.save_every = save_every
        self.keep = keep
        self._preempted = False
        self._pool = concurrent.futures.ThreadPoolExecutor(max_workers=1)
        self._pending = None
        self._prev_sigterm = None

    def install_sigterm_handler(self):
        """On SIGTERM, save at the next step and stop (``preempted``);
        :meth:`close` puts the previous handler back."""
        import signal

        def handler(signum, frame):  # checkpoint before preemption
            self._preempted = True

        self._prev_sigterm = signal.signal(signal.SIGTERM, handler)

    @property
    def preempted(self) -> bool:
        return self._preempted

    def wait(self):
        if self._pending is not None:
            self._pending.result()
            self._pending = None

    def latest_step(self) -> Optional[int]:
        """Step of the newest complete checkpoint, or None."""
        self.wait()
        latest = latest_checkpoint(self.dir)
        return None if latest is None else int(latest.name.split("_", 1)[1])

    def due(self, step: int) -> bool:
        return self._preempted or (step > 0 and step % self.save_every == 0)

    def maybe_save(self, step: int, state, extra=None, *, force: bool = False) -> bool:
        """Save ``state`` at ``step`` when due (or ``force``: a decision the
        ranks of a sharded run took together); returns whether it saved."""
        if not (force or self.due(step)):
            return False
        self.wait()  # one save in flight at a time
        host_state = freezing.tree_map(_to_host, state)
        if not self._preempted:
            self._pending = self._pool.submit(save_checkpoint, self.dir, step, host_state,
                                              extra=extra, keep=self.keep)
        else:  # preemption: write before exit
            save_checkpoint(self.dir, step, host_state, extra=extra, keep=self.keep)
        return True

    def restore(self, device="cpu"):
        self.wait()
        latest = latest_checkpoint(self.dir)
        return None if latest is None else load_checkpoint(latest, device)

    def close(self):
        self.wait()
        self._pool.shutdown()
        if self._prev_sigterm is not None:
            import signal

            signal.signal(signal.SIGTERM, self._prev_sigterm)
            self._prev_sigterm = None
