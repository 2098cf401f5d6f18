"""Data-parallel scaling-efficiency harness.

BASELINE.json's north star includes ">= 80% env-steps/s scaling to N hosts".
This harness measures env-steps/s of the full jitted train epoch at mesh
sizes 1, 2, 4, ... and reports efficiency vs. linear scaling from 1 device.

On a multi-GPU host run it as-is (all local devices), or under
``jax.distributed`` across hosts — the measured program is identical; the
mesh just gets bigger (see ppoc_tpu/parallel/mesh.py).  To rehearse the
sharded program without GPUs, use a virtual CPU mesh (``--platform cpu``
pins the platform through the config API before backend init):

    python bench_scaling.py --platform cpu --devices 8

Prints one JSON line: {"metric": "dp_scaling_efficiency", ...} with the
device record (platform, device_kind, device_count, card).
"""
from __future__ import annotations

import argparse
import json
import sys
import time

from ppoc_tpu.utils import device


def measure(cfg, mesh, n_epochs: int = 5) -> float:
    """Steady-state env-steps/s of the jitted train epoch on ``mesh``."""
    import jax

    from ppoc_tpu.algo.trainer import Trainer

    tr = Trainer(cfg, mesh=mesh)
    key = jax.random.PRNGKey(0)
    s = tr.state
    for i in range(2):  # warm: compile + first run
        s, m = tr._train_epoch(s, jax.random.fold_in(key, i))
        jax.block_until_ready((s, m))
    t0 = time.perf_counter()
    for i in range(n_epochs):
        s, m = tr._train_epoch(s, jax.random.fold_in(key, 100 + i))
    jax.block_until_ready((s, m))
    return n_epochs * cfg.steps_per_epoch / (time.perf_counter() - t0)


def _distributed_measure(args) -> int:
    """Multi-process leg: the whole job forms ONE global mesh; each process
    contributes its local devices.  Measures global env-steps/s of the
    sharded train epoch — run with --num-processes 1 then N and compare for
    the cross-host (DCN) scaling number."""
    import jax

    from ppoc_tpu.config import PPOConfig
    from ppoc_tpu.parallel import make_mesh

    n_dev = len(jax.devices())
    per_dev_envs, per_dev_mb = 256, 1024
    cfg = PPOConfig(
        env=args.env, n_envs=per_dev_envs * n_dev, rollout_len=200,
        minibatch_size=per_dev_mb * n_dev, fits_per_epoch=1,
        eval_envs=8 * n_dev, eval_len=200,
    )
    sps = measure(cfg, make_mesh(), args.epochs)
    if jax.process_index() == 0:
        out = {
            "metric": "dp_steps_per_s_distributed",
            "value": round(sps),
            "unit": f"env_steps_per_s_at_{jax.process_count()}proc_{n_dev}dev",
            "vs_baseline": None,
            "device": device.record(),
        }
        print(json.dumps(out), flush=True)
    jax.distributed.shutdown()
    return 0


def _sweep_measure(args) -> int:
    """Seed-parallel sweep throughput: wall-clock of S vmapped seeds vs S
    sequential runs of the same schedule (ppoc_tpu.sweep.train_many).

    The win comes from batching whole programs onto hardware the
    reference-scale program underutilizes, so on a real chip the batched
    cost should grow far slower than linearly; on CPU this validates the
    program and gives a lower bound.
    """
    import jax

    from ppoc_tpu import sweep
    from ppoc_tpu.config import PPOConfig

    S = args.sweep
    cfg = PPOConfig(env=args.env, fits_per_epoch=2, eval_envs=64)

    def run(seeds):
        out = sweep.train_many(cfg, seeds, n_epochs=args.epochs)
        jax.block_until_ready(out["states"])
        return out

    run([0])  # compile both shapes before timing
    run(list(range(S)))
    t0 = time.perf_counter()
    run([0])
    t1 = (time.perf_counter() - t0)
    t0 = time.perf_counter()
    out = run(list(range(S)))
    tS = (time.perf_counter() - t0)
    speedup = S * t1 / tS
    print(json.dumps({
        "metric": "seed_sweep_speedup",
        "value": round(speedup, 2),
        "unit": f"x_vs_{S}_sequential_runs",
        "vs_baseline": None,
        "t_1seed_s": round(t1, 3),
        f"t_{S}seed_s": round(tS, 3),
        "final_R": [round(float(r), 1) for r in out["R"][:, -1]],
        "device": device.record(),
    }), flush=True)
    return 0


def _pinned_row(args) -> int:
    """Child-process leg of --pin-cores: pin this process to exactly N
    physical cores BEFORE backend init (Eigen sizes the XLA:CPU thread pool
    from the affinity mask), build an N-device virtual mesh, measure one
    weak-scaling row, print one JSON line."""
    import os

    n = args.row
    os.sched_setaffinity(0, set(range(n)))
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_num_cpu_devices", n)

    from ppoc_tpu.config import PPOConfig
    from ppoc_tpu.parallel import make_mesh

    per_dev_envs, per_dev_mb = args.per_dev_envs, args.per_dev_mb
    cfg = PPOConfig(
        env=args.env, n_envs=per_dev_envs * n, rollout_len=200,
        minibatch_size=per_dev_mb * n, fits_per_epoch=1,
        eval_envs=8 * n, eval_len=200,
    )
    mesh = make_mesh(n) if n > 1 else None
    sps = measure(cfg, mesh, args.epochs)
    print(json.dumps({"n": n, "steps_per_s": sps,
                      "device": device.record()}), flush=True)
    return 0


def _pinned_measure(args) -> int:
    """Honest weak scaling on virtual CPU devices: every row gets ONE core
    per device (subprocess + sched_setaffinity before backend init), so the
    1-device baseline cannot borrow the whole socket's intra-op parallelism
    and the N-device rows measure the collective design, not core
    oversubscription.  Rows needing more cores than
    the machine has are skipped (they would measure oversubscription
    again)."""
    import os
    import subprocess

    n_cores = len(os.sched_getaffinity(0))
    n_max = min(args.devices or n_cores, n_cores)
    sizes = [n for n in (1, 2, 4, 8, 16, 32) if n <= n_max]
    results = {}
    for n in sizes:
        cmd = [sys.executable, __file__, "--pin-cores", "--row", str(n),
               "--env", args.env, "--epochs", str(args.epochs),
               "--per-dev-envs", str(args.per_dev_envs),
               "--per-dev-mb", str(args.per_dev_mb)]
        out = subprocess.run(cmd, capture_output=True, text=True, check=True)
        row = json.loads(out.stdout.strip().splitlines()[-1])
        results[n] = row["steps_per_s"]
        print(f"mesh={n} ({n} pinned cores): {results[n]/1e3:.0f}k "
              f"env-steps/s ({results[n] / (results[1] * n) * 100:.0f}% of "
              f"linear)", file=sys.stderr, flush=True)
    n_top = sizes[-1]
    eff = results[n_top] / (results[1] * n_top)
    print(json.dumps({
        "metric": "dp_scaling_efficiency_pinned",
        "value": round(eff, 3),
        "unit": f"fraction_of_linear_at_{n_top}dev_1core_each",
        "vs_baseline": round(eff / 0.80, 2),
        "steps_per_s": {str(k): round(v) for k, v in results.items()},
        "device": row["device"],
        "note": "one pinned physical core per virtual device in every row "
                "(subprocess + sched_setaffinity before backend init): the "
                "baseline and the mesh rows get identical per-device "
                "compute, so the efficiency measures the sharded program + "
                "collectives, not core oversubscription",
    }), flush=True)
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--sweep", type=int, default=0, metavar="S",
                    help="measure seed-parallel sweep speedup (S vmapped "
                         "seeds vs S sequential runs) instead of dp scaling")
    ap.add_argument("--pin-cores", action="store_true",
                    help="weak scaling with ONE pinned physical core per "
                         "virtual device (one subprocess per row; CPU only) "
                         "— measures the collective design, not core "
                         "oversubscription")
    ap.add_argument("--row", type=int, default=None,
                    help=argparse.SUPPRESS)  # internal: --pin-cores child
    ap.add_argument("--per-dev-envs", type=int, default=256,
                    help="pin-cores mode: envs per device (weak scaling)")
    ap.add_argument("--per-dev-mb", type=int, default=1024,
                    help="pin-cores mode: minibatch rows per device")
    ap.add_argument("--devices", type=int, default=None,
                    help="max mesh size (default: all available; in "
                         "--distributed mode, per-PROCESS device count)")
    ap.add_argument("--platform", default=None, choices=["cpu", "gpu"],
                    help="force backend BEFORE init (cpu => virtual mesh)")
    ap.add_argument("--env", default="pendulum")
    ap.add_argument("--epochs", type=int, default=5)
    ap.add_argument("--coordinator", metavar="HOST:PORT", default=None,
                    help="multi-process mode: jax.distributed coordinator; "
                         "requires --num-processes/--process-id. Launch one "
                         "copy per host; the mesh spans all global devices "
                         "and only rank 0 prints")
    ap.add_argument("--num-processes", type=int, default=None)
    ap.add_argument("--process-id", type=int, default=None)
    args = ap.parse_args(argv)

    if args.pin_cores:
        if args.row is not None:
            return _pinned_row(args)
        return _pinned_measure(args)

    import jax

    if args.platform:
        jax.config.update("jax_platforms", args.platform)
        if args.platform == "cpu" and args.devices:
            jax.config.update("jax_num_cpu_devices", args.devices)

    if args.sweep:
        return _sweep_measure(args)

    if args.coordinator is not None:
        if None in (args.num_processes, args.process_id):
            ap.error("--coordinator needs --num-processes and --process-id")
        from ppoc_tpu.parallel.mesh import initialize_distributed

        initialize_distributed(args.coordinator, args.num_processes,
                               args.process_id)
        return _distributed_measure(args)
    if args.devices and len(jax.devices()) < args.devices:
        raise SystemExit(
            f"need {args.devices} devices, have {len(jax.devices())} "
            f"on platform {jax.default_backend()} (try --platform cpu)"
        )

    from ppoc_tpu.config import PPOConfig
    from ppoc_tpu.parallel import make_mesh

    n_max = args.devices or len(jax.devices())
    sizes = [n for n in (1, 2, 4, 8, 16, 32) if n <= n_max]

    # Weak scaling: per-device work fixed (the production regime — more
    # devices run more envs), so ideal is constant time per epoch.
    per_dev_envs, per_dev_mb = 256, 1024
    results = {}
    for n in sizes:
        cfg = PPOConfig(
            env=args.env, n_envs=per_dev_envs * n, rollout_len=200,
            minibatch_size=per_dev_mb * n, fits_per_epoch=1,
            eval_envs=8 * n, eval_len=200,
        )
        mesh = make_mesh(n) if n > 1 else None
        sps = measure(cfg, mesh, args.epochs)
        results[n] = sps
        print(f"mesh={n}: {sps/1e3:.0f}k env-steps/s "
              f"({sps / (results[1] * n) * 100:.0f}% of linear)",
              file=sys.stderr, flush=True)

    n_top = sizes[-1]
    eff = results[n_top] / (results[1] * n_top)
    out = {
        "metric": "dp_scaling_efficiency",
        "value": round(eff, 3),
        "unit": f"fraction_of_linear_at_{n_top}dev",
        "vs_baseline": round(eff / 0.80, 2),
        "steps_per_s": {str(k): round(v) for k, v in results.items()},
        "device": device.record(),
    }
    if jax.default_backend() == "cpu":
        out["note"] = (
            "virtual CPU devices share physical cores: this validates the "
            "sharded program, not interconnect scaling — efficiency is "
            "expected to be far below the >=80% target that applies to "
            "real multi-GPU meshes"
        )
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
