"""The port's int8 gradient mean (``distributed.compression._quantize_pmean``)
over 2 and 4 gloo ranks on the CPU against the JAX package's, which runs
under ``jax.vmap(..., axis_name="data")`` on the same per-rank gradients
stacked (made from a seed with numpy):

* at 2 ranks the means are the same bits (the scale mean adds two floats,
  which commutes);
* at 4 ranks the scales' sum may be taken in another order, so each mean
  is within one float32 ulp of the scale carried through (3 ulps of the
  output: the scale's, then the product's and the quotient's roundings);
* int32 and 0-d leaves take the plain mean;
* the wire carries int8 for the gradients and one float32 scalar (the
  scale) each, recorded with the leaf's path.

One group of 4 ranks for both counts, about 10 s with the processes' imports."""

import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.distributed.compression import _quantize_pmean as j_quantize_pmean

torch.set_num_threads(1)

SRC = str(Path(__file__).resolve().parents[1] / "src")
ENV = {"PYTHONPATH": os.pathsep.join(filter(None, [SRC, os.environ.get("PYTHONPATH")]))}
LEAVES = {"w": ((6, 10), np.float32), "v": ((3, 4, 5), np.float32),
          "b": ((16,), "bfloat16"), "count": ((4,), np.int32), "s": ((), np.float32)}

_WORKER = r"""
import json, sys
import numpy as np, torch, ml_dtypes
torch.set_num_threads(1)
from repro_torch.distributed import collectives
from repro_torch.distributed.compression import _quantize_pmean
from repro_torch.launch.mesh import make_host_mesh
import os
rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
d = sys.argv[1]
collectives.init_process_group("gloo", "env://", rank, world)
# a mesh of the first n ranks for each n: the others idle, as leftover devices do
for n in (2, 4):
    mesh = make_host_mesh(n, 1)
    if rank >= n:
        continue
    data = np.load(d + f"/in{n}.npz")
    res = {}
    with collectives.recording() as rec:
        for name in json.loads(sys.argv[2]):
            a = data[f"{name}_{rank}"]
            if name == "b":
                g = torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
            else:
                g = torch.from_numpy(a)
            r = _quantize_pmean(g, mesh, "data", n, path=name)
            res[name] = r.float().numpy() if r.dtype == torch.bfloat16 else r.numpy()
    np.savez(d + f"/out{n}.{rank}.npz", **res)
    json.dump([[c.op, c.dtype, c.bytes, c.path] for c in rec], open(d + f"/out{n}.{rank}.json", "w"))
collectives.destroy_process_group()
"""


def _torchrun(args, n, *, timeout, env):
    """``python -m torch.distributed.run --standalone`` with ``n`` ranks on
    ``args``: (return code, stdout, stderr), each rank's lines prefixed
    ``[default<rank>]:``.  A failed rank stops the others and fails the run;
    past ``timeout`` the launcher is stopped, which stops its ranks."""
    p = subprocess.Popen([sys.executable, "-m", "torch.distributed.run", "--standalone",
                          f"--nproc-per-node={n}", "--tee=3", *args],
                         stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                         env=dict(os.environ, **env))
    try:
        out, err = p.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        p.terminate()
        out, err = p.communicate()
    return p.returncode, out, err


def _grads(n):
    rng = np.random.default_rng(100 + n)
    out = {}
    for name, (shape, dt) in LEAVES.items():
        for r in range(n):
            if dt == np.int32:
                a = rng.integers(-50, 50, shape).astype(np.int32)
            else:
                # ranks of different magnitudes, so the scales differ
                a = (rng.standard_normal(shape) * (r + 1) * 1e-3).astype(np.float32)
                if dt == "bfloat16":
                    import ml_dtypes
                    a = a.astype(ml_dtypes.bfloat16)
            out[f"{name}_{r}"] = a
    return out


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """One group of 4 gloo ranks: the 2-rank mesh on ranks 0-1, then the
    4-rank mesh."""
    d = tmp_path_factory.mktemp("int8")
    for n in (2, 4):
        np.savez(d / f"in{n}.npz", **{k: (v.view(np.int16) if v.dtype.name == "bfloat16" else v)
                                      for k, v in _grads(n).items()})
    rc, _, err = _torchrun(["--no-python", sys.executable, "-c", _WORKER, str(d),
                            json.dumps(list(LEAVES))], 4, timeout=240, env=ENV)
    assert rc == 0, err[-3000:]
    return d


@pytest.fixture(scope="module", params=[2, 4])
def group(request, ranks):
    n, d = request.param, ranks
    grads = _grads(n)
    port = [dict(np.load(d / f"out{n}.{r}.npz")) for r in range(n)]
    logs = [json.load(open(d / f"out{n}.{r}.json")) for r in range(n)]
    want = {}
    for name in LEAVES:
        stacked = jnp.stack([jnp.asarray(grads[f"{name}_{r}"]) for r in range(n)])
        f = jax.vmap(lambda g: j_quantize_pmean(g, "data", n), axis_name="data")
        want[name] = np.asarray(f(stacked), np.float32)
    return n, grads, port, logs, want


@pytest.mark.parametrize("name", ["w", "v", "b"])
def test_int8_mean_matches_jax(group, name):
    n, _, port, _, want = group
    for r in range(n):
        got = port[r][name].astype(np.float32)
        if n == 2:
            np.testing.assert_array_equal(got, want[name][r])
        else:
            np.testing.assert_allclose(got, want[name][r], rtol=3 * 2.0 ** -23, atol=0)


def test_every_rank_holds_the_same_mean(group):
    n, _, port, _, _ = group
    for name in LEAVES:
        for r in range(1, n):
            np.testing.assert_array_equal(port[r][name], port[0][name])


@pytest.mark.parametrize("name", ["count", "s"])
def test_int32_and_scalar_leaves_take_the_plain_mean(group, name):
    n, grads, port, logs, want = group
    plain = sum(grads[f"{name}_{r}"].astype(np.float64) for r in range(n)) / n
    np.testing.assert_allclose(port[0][name].astype(np.float64), plain, rtol=1e-6)
    np.testing.assert_allclose(port[0][name], want[name][0], rtol=3 * 2.0 ** -23)
    ops = [(op, dt) for op, dt, _, path in logs[0] if path == name]
    assert ops == [("all-reduce", "int32" if name == "count" else "float32")]


def test_wire_is_int8_with_one_float32_scale(group):
    n, grads, _, logs, _ = group
    for name in ("w", "v", "b"):
        ops = [(op, dt, nb) for op, dt, nb, path in logs[0] if path == name]
        size = grads[f"{name}_0"].size
        assert ops == [("all-reduce", "int8", size), ("all-reduce", "float32", 4)], ops
