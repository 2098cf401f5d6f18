"""Elastic recovery: supervisor restart loop, fault injection, preemption.

The reference has no failure handling (SURVEY.md §5: CUDA errors abort,
bridge errors continue with garbage).  Here the contract under test is the
full elastic story: a training run hard-killed mid-schedule (the documented
PPOC_FAULT_EPOCH drill hook) is restarted by utils/supervisor.py from its
latest checkpoint and finishes the ORIGINAL schedule — producing the
bit-identical final state of an uninterrupted run (bit-exact resume +
epochs_done metadata), and a SIGTERM'd run checkpoints gracefully and exits
with the restartable PREEMPTED_EXIT code.
"""
import json
import os
import signal
import subprocess
import sys
import time

import numpy as np
import pytest

from ppoc_tpu.utils import supervisor

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

BASE_ARGS = [
    "--env", "simple", "--n-envs", "8", "--rollout-len", "15",
    "--minibatch-size", "32", "--fits-per-epoch", "1", "--hidden", "8", "8",
    "--eval-envs", "8", "--eval-len", "15", "--kernel-backend", "jnp",
    "--seed", "1", "--n-epochs", "4",
]


def _child_env(**extra):
    env = dict(os.environ)
    # the CLI's PPOC_PLATFORM hook pins the child to the CPU through the
    # config API
    env["PPOC_PLATFORM"] = "cpu"
    env.pop("PPOC_FAULT_EPOCH", None)
    env.update(extra)
    return env


def _run_cli(args, **extra_env):
    return subprocess.run(
        [sys.executable, "-m", "ppoc_tpu", *args],
        cwd=REPO, env=_child_env(**extra_env),
        capture_output=True, text=True, timeout=300,
    )


# -- unit: restart-argv rewriting -------------------------------------------

def test_build_restart_argv_device():
    argv = ["--env", "simple", "--load", "old.bin", "--supervise", "3",
            "--save", "ck.bin", "--checkpoint-every", "1"]
    out = supervisor.build_restart_argv(argv, "ck.bin", gym_env=False)
    assert "--load" not in out[:-2] and "--supervise" not in out
    assert out[-2:] == ["--resume", "ck.bin"]
    assert "--save" in out and "--checkpoint-every" in out


def test_build_restart_argv_gym():
    argv = ["--env", "gym:LunarLanderContinuous-v3", "--resume", "x.bin",
            "--save", "ck.bin"]
    out = supervisor.build_restart_argv(argv, "ck.bin", gym_env=True)
    assert "--resume" not in out
    assert out[-2:] == ["--load", "ck.bin"]


# -- unit: the restart loop with a fake runner --------------------------------

def test_supervise_restarts_until_success(tmp_path):
    ck = str(tmp_path / "ck.bin")
    calls = []

    def runner(argv):
        calls.append(list(argv))
        if len(calls) == 1:
            return 98  # crash before any checkpoint
        if len(calls) == 2:
            open(ck, "wb").write(b"x")  # checkpoint appeared, then crash
            return supervisor.PREEMPTED_EXIT
        return 0

    rc = supervisor.supervise(["first"], ["restart"], ck, max_restarts=5,
                              backoff_s=0, runner=runner, log=lambda m: None)
    assert rc == 0
    # crash #1: no checkpoint yet -> original argv again; crash #2 left a
    # checkpoint -> restart argv
    assert calls == [["first"], ["first"], ["restart"]]


def test_supervise_gives_up_after_max_restarts(tmp_path):
    ck = str(tmp_path / "ck.bin")
    open(ck, "wb").write(b"x")
    calls = []

    def runner(argv):
        calls.append(1)
        return 7

    rc = supervisor.supervise(["a"], ["b"], ck, max_restarts=3,
                              backoff_s=0, runner=runner, log=lambda m: None)
    assert rc == 7
    assert len(calls) == 4  # initial + 3 restarts


# -- integration: fault injection -> crash -> resume completes the schedule --

@pytest.mark.slow
def test_fault_injected_crash_then_elastic_completion(tmp_path):
    ck = str(tmp_path / "elastic.bin")
    args = BASE_ARGS + ["--save", ck, "--checkpoint-every", "1"]

    # child 1: hard-killed right after epoch 2's checkpoint
    r = _run_cli(args, PPOC_FAULT_EPOCH="2")
    assert r.returncode == 98, r.stderr
    from ppoc_tpu.utils import checkpoint
    assert checkpoint.load(ck).meta["epochs_done"] == 2

    # supervisor flow: restart with --resume finishes the ORIGINAL 4-epoch
    # schedule (remaining epochs come from the file's epochs_done)
    restart = supervisor.build_restart_argv(args, ck, gym_env=False)
    r2 = _run_cli(restart)
    assert r2.returncode == 0, r2.stderr
    ck_resumed = checkpoint.load(ck)

    # uninterrupted twin: identical flags, no fault
    ck2 = str(tmp_path / "straight.bin")
    r3 = _run_cli(BASE_ARGS + ["--save", ck2, "--checkpoint-every", "1"])
    assert r3.returncode == 0, r3.stderr
    ck_straight = checkpoint.load(ck2)

    # crash + restart == never crashed, bit for bit (state AND RNG key)
    import jax
    for a, b in zip(jax.tree.leaves(ck_resumed.state),
                    jax.tree.leaves(ck_straight.state)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    np.testing.assert_array_equal(np.asarray(ck_resumed.key),
                                  np.asarray(ck_straight.key))

    # a further restart has nothing to do and exits cleanly
    r4 = _run_cli(restart)
    assert r4.returncode == 0 and "nothing to resume" in r4.stderr, r4.stderr


@pytest.mark.slow
def test_supervise_cli_end_to_end(tmp_path):
    """--supervise drives the whole loop: crash at epoch 2, auto-restart,
    original schedule completed."""
    ck = str(tmp_path / "sup.bin")
    args = BASE_ARGS + ["--save", ck, "--checkpoint-every", "1",
                        "--supervise", "3"]
    r = _run_cli(args, PPOC_FAULT_EPOCH="2")
    assert r.returncode == 0, (r.stdout, r.stderr)
    assert "restart" in r.stderr
    from ppoc_tpu.utils import checkpoint
    meta = checkpoint.load(ck).meta
    # the run reached the full original schedule across processes
    assert meta.get("epochs_done") == 4, meta


@pytest.mark.slow
def test_fault_epoch_counts_global_epochs(tmp_path):
    """PPOC_FAULT_EPOCH fires ONCE at the global epoch, not again in every
    restarted child: a restart at epoch_offset >= fault_epoch must run
    clean even though it inherits the env var."""
    ck = str(tmp_path / "once.bin")
    args = BASE_ARGS + ["--save", ck, "--checkpoint-every", "1"]
    r = _run_cli(args, PPOC_FAULT_EPOCH="2")
    assert r.returncode == 98
    restart = supervisor.build_restart_argv(args, ck, gym_env=False)
    # restarted child inherits the fault var; local epoch 2 == global 4,
    # so the drill must NOT re-fire at global epoch 4 != 2... and
    # certainly not at local epoch 2 (the round-1 bug): the run completes
    r2 = _run_cli(restart, PPOC_FAULT_EPOCH="2")
    assert r2.returncode == 0, (r2.stdout, r2.stderr)
    from ppoc_tpu.utils import checkpoint
    assert checkpoint.load(ck).meta["epochs_done"] == 4


@pytest.mark.slow
def test_sigterm_graceful_preemption(tmp_path):
    """SIGTERM mid-run: the child finishes the epoch, checkpoints with a
    cumulative epochs_done, and exits PREEMPTED_EXIT (restartable)."""
    ck = str(tmp_path / "preempt.bin")
    args = BASE_ARGS.copy()
    args[args.index("--n-epochs") + 1] = "500"  # long run; we interrupt it
    args += ["--save", ck, "--checkpoint-every", "1"]
    p = subprocess.Popen(
        [sys.executable, "-m", "ppoc_tpu", *args],
        cwd=REPO, env=_child_env(), stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True,
    )
    try:
        deadline = time.time() + 240
        while not os.path.exists(ck) and time.time() < deadline:
            if p.poll() is not None:
                break
            time.sleep(0.2)
        assert os.path.exists(ck), p.communicate()
        p.send_signal(signal.SIGTERM)
        out, err = p.communicate(timeout=120)
    finally:
        if p.poll() is None:
            p.kill()
    assert p.returncode == supervisor.PREEMPTED_EXIT, (p.returncode, err)
    assert "preempted: checkpointed" in err
    from ppoc_tpu.utils import checkpoint
    ckpt = checkpoint.load(ck)
    assert ckpt.meta.get("epochs_done", 0) >= 1


def test_supervise_flag_validation():
    from ppoc_tpu import cli

    with pytest.raises(SystemExit):
        cli.main(["--supervise", "2"])  # no --save/--checkpoint-every
    with pytest.raises(SystemExit):
        cli.main(["--supervise", "2", "--save", "x.bin",
                  "--checkpoint-every", "1", "--solve-R", "0.5"])


def test_supervisor_parent_never_initializes_a_backend(tmp_path):
    """The --supervise parent parses, validates and spawns without ever
    initializing a JAX backend: on a GPU host the training child must be
    the one process that reserves the card's memory."""
    code = (
        "import sys\n"
        "from ppoc_tpu import cli\n"
        "from ppoc_tpu.utils import supervisor\n"
        "seen = []\n"
        "supervisor.supervise = lambda *a, **k: seen.append(a) or 0\n"
        f"rc = cli.main({BASE_ARGS + ['--save', str(tmp_path / 's.bin'), '--checkpoint-every', '1', '--supervise', '2']!r})\n"
        "import jax._src.xla_bridge as xb\n"
        "print(rc, len(seen), sorted(xb._backends))\n"
    )
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=300, cwd=REPO, env=_child_env())
    assert r.returncode == 0, r.stderr
    assert r.stdout.split() == ["0", "1", "[]"], (r.stdout, r.stderr)
