"""Elastic recovery: checkpoint-based restart supervision.

The reference has no failure handling at all — CUDA errors abort
(include/cuda_helper.h:13-15) and Python-bridge errors print and continue
with garbage (src/gym_env.c:29,33,56,90); SURVEY.md §5 marks the subsystem
"none".  On accelerator fleets, preemption (maintenance events) and
transient host failures are ordinary, so the framework supplies the standard
recipe: frequent self-describing checkpoints (utils/checkpoint.py, written
with an ``epochs_done`` metadata counter) + a supervisor that relaunches a
crashed or preempted run from the newest checkpoint until the ORIGINAL
schedule completes.

Three cooperating pieces (all exercised in tests/test_supervisor.py):

  * :func:`supervise` — the restart loop.  Runs the training command; on a
    non-zero exit it relaunches with ``restart_argv`` once a checkpoint
    exists (first crash before any checkpoint retries the original argv).
    Exit code 0 stops; ``max_restarts`` bounds crash-looping.
  * CLI ``--supervise N`` (ppoc_tpu/cli.py) — builds the restart argv for
    either trainer flavor: device envs restart with ``--resume CKPT`` (the
    bit-exact path; remaining epochs come from the checkpoint's
    ``epochs_done``), gym host-bridge envs restart with ``--load CKPT``
    (optimizer/PRNG/norm-stats exact; live envs are not serializable so
    episodes restart fresh).
  * Graceful preemption — the supervised child installs a SIGTERM handler
    that finishes the current epoch, checkpoints, and exits with
    :data:`PREEMPTED_EXIT` so the supervisor restarts it (the
    maintenance-event flow).  Fault injection for drills:
    ``PPOC_FAULT_EPOCH=k`` hard-kills the child right after epoch k's
    checkpoint (SURVEY §5 notes the reference lacks any fault-injection
    harness).
"""
from __future__ import annotations

import os
import sys
import time
from typing import Callable, List, Optional, Sequence

# child exited after a graceful SIGTERM checkpoint; always restartable
PREEMPTED_EXIT = 75  # EX_TEMPFAIL


def _default_runner(argv: Sequence[str]) -> int:
    import subprocess

    return subprocess.call([sys.executable, "-m", "ppoc_tpu", *argv])


def supervise(
    first_argv: Sequence[str],
    restart_argv: Sequence[str],
    checkpoint_path: str,
    max_restarts: int = 10,
    backoff_s: float = 1.0,
    runner: Optional[Callable[[Sequence[str]], int]] = None,
    log: Callable[[str], None] = lambda m: print(m, file=sys.stderr, flush=True),
) -> int:
    """Run ``first_argv``; on failure, rerun ``restart_argv`` (or
    ``first_argv`` again while no checkpoint exists yet) until success or
    ``max_restarts`` restarts are exhausted.  Returns the final exit code.

    ``runner`` (argv -> exit code) defaults to launching the ppoc_tpu CLI
    in a subprocess; tests inject fakes.
    """
    runner = _default_runner if runner is None else runner
    argv: List[str] = list(first_argv)
    # only trust checkpoints written DURING this supervision: a stale file
    # left at the same path by an earlier experiment must not hijack the
    # restart (on --resume the config comes entirely from the file)
    started = time.time()

    def _fresh_checkpoint() -> bool:
        try:
            return os.path.getmtime(checkpoint_path) >= started
        except OSError:
            return False

    for attempt in range(max_restarts + 1):
        rc = runner(argv)
        if rc == 0:
            if attempt:
                log(f"supervisor: run completed after {attempt} restart(s)")
            return 0
        if attempt == max_restarts:
            log(f"supervisor: giving up after {max_restarts} restarts "
                f"(last exit code {rc})")
            return rc
        if _fresh_checkpoint():
            argv = list(restart_argv)
            why = "resuming from checkpoint"
        else:
            argv = list(first_argv)
            why = "no checkpoint from this run yet, retrying from scratch"
        kind = "preempted" if rc == PREEMPTED_EXIT else f"exit code {rc}"
        log(f"supervisor: run {kind}; restart {attempt + 1}/{max_restarts} "
            f"({why})")
        if backoff_s:
            time.sleep(backoff_s)
    return rc  # pragma: no cover (loop always returns)


def build_restart_argv(argv: Sequence[str], checkpoint_path: str,
                       gym_env: bool) -> List[str]:
    """Rewrite a CLI argv into its crash-restart form.

    Strips any prior --load/--resume/--import-ref and the --supervise flag
    itself, then points the run at the checkpoint: ``--resume`` for device
    envs (bit-exact; remaining epochs from the file's epochs_done),
    ``--load`` for gym host-bridge envs (state-exact, fresh episodes).
    ``--n-epochs`` is dropped too: on --resume an explicit flag means
    "train this many MORE epochs", but an elastic restart must finish the
    ORIGINAL schedule — which the checkpoint carries (cfg.n_epochs minus
    the epochs_done metadata).
    """
    out: List[str] = []
    skip = False
    drop_with_value = {"--load", "--resume", "--import-ref", "--supervise"}
    # --calibrate is a fresh-run flag (it measured statistics that now live
    # in the checkpoint's config); a --resume restart would be rejected by
    # the CLI's calibrate-vs-resume guard
    drop_bare = {"--calibrate"}
    if not gym_env:
        # gym restarts run from flags (--load), so --n-epochs must survive
        drop_with_value.add("--n-epochs")
    for a in argv:
        if skip:
            skip = False
            continue
        if a in drop_with_value:
            skip = True
            continue
        if a in drop_bare:
            continue
        if any(a.startswith(d + "=") for d in drop_with_value):
            continue
        out.append(a)
    out += ["--load", checkpoint_path] if gym_env \
        else ["--resume", checkpoint_path]
    return out
