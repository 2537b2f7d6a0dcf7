"""The port's checkpoints and training CLI against the JAX package's, on
the CPU: the on-disk format is shared (a bf16 leaf's ``.npy`` bytes are
identical, and each package loads the other's checkpoints), a JAX run
resumes in the port's ``train.main`` with the losses JAX itself goes on
to, the port resumes its own runs, flags of unported features are
rejected, and ``bridge`` carries NamedTuple states."""

import shutil
import signal

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.checkpoint import store as jstore
from repro.launch import train as jtrain
from repro.optim.optimizers import OptState as JOptState
from repro_torch import bridge
from repro_torch.checkpoint import store
from repro_torch.launch import train

torch.set_num_threads(1)

TOL = 1e-5  # float32 losses: the same products summed in another order
SMOKE = ["--arch", "smollm-360m", "--smoke", "--lrd", "--lrd-min-dim", "16",
         "--no-rank-opt", "--freeze", "sequential", "--steps-per-epoch", "2",
         "--global-batch", "2", "--seq-len", "16", "--log-every", "100"]


def _tree():
    rng = np.random.default_rng(0)
    w = rng.standard_normal((3, 5)).astype(np.float32)
    return {"params": {"w": w, "b": w[0].astype(ml_dtypes.bfloat16)},
            "step": np.int32(7), "mu": {"w": w * 2}, "nu": ()}


def test_bf16_leaves_and_manifests_are_byte_identical(tmp_path):
    tree = _tree()
    jstore.save_checkpoint(tmp_path / "jax", 7, tree, extra={"phase": 1})
    store.save_checkpoint(tmp_path / "port", 7, bridge.from_numpy(tree), extra={"phase": 1})
    jdir, tdir = tmp_path / "jax" / "step_00000007", tmp_path / "port" / "step_00000007"
    assert sorted(p.name for p in jdir.iterdir()) == sorted(p.name for p in tdir.iterdir())
    for p in jdir.iterdir():
        assert (tdir / p.name).read_bytes() == p.read_bytes(), p.name
    loaded, step, extra = store.load_checkpoint(tdir)
    assert step == 7 and extra == {"phase": 1} and loaded["nu"] == ()
    assert loaded["params"]["b"].dtype == torch.bfloat16
    np.testing.assert_array_equal(loaded["params"]["b"].view(torch.int16).numpy(),
                                  tree["params"]["b"].view(np.int16))
    np.testing.assert_array_equal(loaded["mu"]["w"].numpy(), tree["mu"]["w"])


def test_port_checkpoint_loads_in_jax_with_equal_leaves(tmp_path):
    train.main(["--device", "cpu", *SMOKE, "--steps", "2", "--save-every", "2",
                "--ckpt-dir", str(tmp_path)])
    latest = jstore.latest_checkpoint(tmp_path / "smollm-360m-smoke")
    jstate, jstep, jextra = jstore.load_checkpoint(latest)
    tstate, tstep, textra = store.load_checkpoint(latest)
    assert jstep == tstep == 2 and jextra == textra and jextra["phase"] == 0
    flat_j, flat_t = jstore._flatten(jstate), store._flatten(tstate)
    assert flat_j.keys() == flat_t.keys()
    for k, v in flat_j.items():
        if v is None:  # an empty tuple (sgdm's nu)
            assert flat_t[k] is None, k
            continue
        np.testing.assert_array_equal(np.asarray(v), flat_t[k].numpy(), err_msg=k)
    # JAX's resume path takes it: re-partition for the saved phase
    (tr, fr, opt), parked = jstore.unpack_phased_state(
        jstate, jextra["phase"], expect_rank_map=jextra["rank_map"])
    assert jax.tree_util.tree_leaves(tr) and jax.tree_util.tree_leaves(parked[0])


def test_jax_run_resumes_in_the_port_with_jax_losses(tmp_path):
    """JAX trains 4 steps saving at 2 and 4; the port resumes from JAX's
    step-2 checkpoint (weights, moments, data state, phase) and its steps
    2 and 3 (a phase swap at 2) give JAX's losses."""
    _, jlosses = jtrain.main([*SMOKE, "--steps", "4", "--save-every", "2",
                              "--ckpt-dir", str(tmp_path / "jax")])
    # JAX's step-2 save completed before its step-4 save was queued
    step2 = "smollm-360m-smoke/step_00000002"
    shutil.copytree(tmp_path / "jax" / step2, tmp_path / "port" / step2)
    seen = []
    _, losses = train.main(["--device", "cpu", *SMOKE, "--steps", "4", "--save-every", "100",
                            "--ckpt-dir", str(tmp_path / "port")],
                           on_step=lambda step, phase, m: seen.append((step, phase)))
    assert seen == [(2, 1), (3, 1)]
    np.testing.assert_allclose(losses, jlosses[2:], rtol=TOL, atol=TOL)


def test_port_run_resumes_across_a_phase_swap(tmp_path):
    sigterm = signal.getsignal(signal.SIGTERM)
    argv = ["--device", "cpu", *SMOKE, "--save-every", "2"]
    _, straight = train.main([*argv, "--steps", "4", "--ckpt-dir", str(tmp_path / "a")])
    _, first = train.main([*argv, "--steps", "2", "--ckpt-dir", str(tmp_path / "b")])
    seen = []
    _, rest = train.main([*argv, "--steps", "4", "--ckpt-dir", str(tmp_path / "b")],
                         on_step=lambda step, phase, m: seen.append((step, phase)))
    assert seen == [(2, 1), (3, 1)]
    np.testing.assert_allclose(first + rest, straight, rtol=TOL, atol=TOL)
    assert store.latest_checkpoint(tmp_path / "b" / "smollm-360m-smoke").name == "step_00000004"
    assert signal.getsignal(signal.SIGTERM) is sigterm  # the CLI put its handler back


@pytest.mark.parametrize("flags", [
    ["--mesh", "production"], ["--mesh-data", "2"], ["--mesh-model", "2"], ["--fsdp"],
    ["--grad-compression", "int8"], ["--remat", "full"], ["--obs"],
    ["--profile-steps", "1:2"], ["--log-format", "jsonl"], ["--pallas-interpret"],
    ["--arch", "olmoe-1b-7b"]])
def test_train_cli_rejects_unported_flags(flags, capsys):
    with pytest.raises(SystemExit) as exc:
        train.main(["--device", "cpu", *SMOKE, "--steps", "1", *flags])
    assert exc.value.code == 2
    assert "ROADMAP" in capsys.readouterr().err


def test_train_cli_trains_at_algorithm_1_ranks(capsys, tmp_path):
    """Without ``--no-rank-opt`` the CLI trains ``--lrd`` at the resolver's
    Algorithm-1 ranks (at smoke size its guard keeps every layer dense, as
    JAX's does)."""
    argv = [a for a in SMOKE if a != "--no-rank-opt"]
    _, losses = train.main(["--device", "cpu", *argv, "--steps", "1",
                            "--ckpt-dir", str(tmp_path)])
    assert len(losses) == 1 and np.isfinite(losses[0])
    assert "kept dense" in capsys.readouterr().out


def test_bridge_round_trips_jax_opt_state():
    rng = np.random.default_rng(1)
    mu = {"a": {"u": rng.standard_normal((4, 2)).astype(np.float32), "v": None}}
    state = JOptState(jnp.asarray(3, jnp.int32), jax.tree_util.tree_map(jnp.asarray, mu), ())
    t = bridge.from_numpy(state)
    assert type(t) is JOptState and t.nu == () and t.mu["a"]["v"] is None
    assert t.step.dtype == torch.int32 and int(t.step) == 3
    back = bridge.to_numpy(t)
    assert type(back) is JOptState
    np.testing.assert_array_equal(back.mu["a"]["u"], mu["a"]["u"])
