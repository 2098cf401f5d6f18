"""Headline benchmark: wall-clock to solve Pendulum-v1 on one GPU.

The reference solves Pendulum-v1 in ~5 s on an RTX 2080 (+CPU rollouts)
(/root/reference/README.md:4, BASELINE.md).  This benchmark trains the same
algorithm with the same hyperparameters (lr/Adam/gamma/lambda/clip, value and
policy epoch counts, advantage normalization scope — src/main.c:33-43) on
vectorized on-device envs with one jitted fit program, and reports the
wall-clock seconds from the start of (post-compile) training until
stochastic-policy eval reaches mean undiscounted return R >= -200.

Prints ONE JSON line:
  {"metric": "pendulum_solve_seconds", "value": <s>, "unit": "s",
   "vs_baseline": <baseline 5 s / value>, "device": {...}}
plus detail fields; progress goes to stderr.  Refuses to run without a GPU.

Usage: python bench.py [--seed N] [--max-epochs N] [--throughput]
"""
from __future__ import annotations

import argparse
import json
import sys
import time

import jax

from ppoc_tpu.algo.trainer import Trainer
from ppoc_tpu.config import PPOConfig
from ppoc_tpu.utils import device
from ppoc_tpu.utils.cache import enable_compilation_cache

BASELINE_SECONDS = 5.0       # reference wall-clock on RTX 2080 (README.md:4)
SOLVE_R = -200.0             # BASELINE.json north star
BENCH_SEED = 0


def bench_config(seed: int) -> PPOConfig:
    """Reference hyperparameters; data collection vectorized.

    64 lockstep envs x 200 steps per fit (12,800 transitions vs the
    reference's 3,000) with minibatch 256 — identical optimizer, clipping,
    normalization and epoch schedule.
    """
    return PPOConfig(
        env="pendulum",
        seed=seed,
        n_envs=64,
        rollout_len=200,
        minibatch_size=256,
        fits_per_epoch=4,
        eval_envs=64,
        eval_len=200,
    )


def solve_benchmark(seed: int, max_epochs: int, log=lambda *a: None,
                    config_fn=None):
    """Train-until-solved as ONE device program (ppo.train_until): the whole
    run — N epochs of rollout+GAE+updates with a stochastic eval after each —
    costs a single host dispatch, so the measurement is compute, not host
    round trips."""

    tr = Trainer((config_fn or bench_config)(seed))
    init_state = tr.state

    # Warm the jit cache AND the device path (compile excluded from the
    # measurement, like the reference's ahead-of-time nvcc build).  With
    # the persistent cache (utils/cache.py) warm this deserializes the
    # solve executable in single-digit seconds; cold it traces+compiles.
    t0 = time.perf_counter()
    for i in range(6):
        t1 = time.perf_counter()
        tr.state = init_state
        r = tr.solve(target_R=SOLVE_R, max_epochs=max_epochs)
        dt = time.perf_counter() - t1
        log(f"warmup solve {i}: {dt:.2f}s {r}")
        if dt < 2.0:
            break
    compile_s = time.perf_counter() - t0
    log(f"warmup+compile total {compile_s:.1f}s")

    # Measured runs: fresh initial state each, one dispatch + one fetch per
    # run; report the MEDIAN of 3 so one unlucky RNG draw (solve-epoch count
    # varies 5-7 across seeds) doesn't define the headline.
    runs = []
    for i in range(3):
        tr.state = init_state
        t0 = time.perf_counter()
        res = tr.solve(target_R=SOLVE_R, max_epochs=max_epochs)
        wall = time.perf_counter() - t0
        runs.append((wall, res["epochs"], res["R"]))
        log(f"measured solve {i}: {res['epochs']} epochs, R={res['R']:.1f}, "
            f"{wall:.3f}s")
    runs.sort()
    wall, epochs, R = runs[len(runs) // 2]
    solved = all(r >= SOLVE_R for _, _, r in runs)
    steps = epochs * tr.cfg.steps_per_epoch
    return {
        "solved": solved,
        "wall_s": wall,
        "epochs": epochs,
        "final_R": R,
        "compile_s": compile_s,
        "all_runs_s": [round(w, 3) for w, _, _ in runs],
        "env_steps": steps,
        "env_steps_per_s": steps / wall if wall > 0 else 0.0,
    }


def throughput_benchmark(seed: int):
    """Secondary metric: steady-state env-steps/s of the full train loop
    (rollout + GAE + 10 value epochs + 4 policy epochs) at production sizes."""
    from ppoc_tpu.config import throughput_preset

    tr = Trainer(throughput_preset("pendulum", seed=seed))
    key = jax.random.PRNGKey(seed)
    s = tr.state
    for i in range(3):  # compile + warmup
        s, m = tr._train_epoch(s, jax.random.fold_in(key, 100 + i))
        jax.block_until_ready((s, m))
    n = 5
    t0 = time.perf_counter()
    for i in range(n):
        s, m = tr._train_epoch(s, jax.random.fold_in(key, i))
    jax.block_until_ready((s, m))
    wall = time.perf_counter() - t0
    return n * tr.cfg.steps_per_epoch / wall


def reference_schedule_config(seed: int) -> PPOConfig:
    """The EXACT reference schedule (src/main.c:33-43): 15 envs x 200 steps
    = 3,000-step fits, minibatch 64, 10 fits/epoch — the apples-to-apples
    configuration vs the published 5 s."""
    return PPOConfig(env="pendulum", seed=seed)


def tuned_config(seed: int) -> PPOConfig:
    """The grid-sweep-winner hyperparameters — now the shared
    ``config.tuned_preset`` (CLI ``--preset tuned``), so the bench and the
    product surface can never drift.  NOT the headline (that keeps the
    reference's exact hyperparameters and schedule); this is what a user
    of the sweep tooling actually gets."""
    from ppoc_tpu.config import tuned_preset

    return tuned_preset("pendulum", seed)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--seed", type=int, default=BENCH_SEED)
    ap.add_argument("--max-epochs", type=int, default=60)
    ap.add_argument("--throughput", action="store_true",
                    help="also measure steady-state env-steps/s "
                         "(throughput preset)")
    ap.add_argument("--reference-schedule", action="store_true",
                    help="run the reference's exact 15x200/mb-64 schedule "
                         "instead of the vectorized bench config")
    ap.add_argument("--tuned", action="store_true",
                    help="use the grid-sweep-winner hyperparameters "
                         "(lr 1e-3 / clip 0.3) instead of the reference's; "
                         "reported as pendulum_solve_seconds_tuned")
    ap.add_argument("--verbose", action="store_true")
    args = ap.parse_args(argv)

    log = (lambda *a: print(*a, file=sys.stderr, flush=True)) if args.verbose \
        else (lambda *a: None)
    enable_compilation_cache()
    rec = device.require_gpu()

    if args.reference_schedule and args.tuned:
        ap.error("--reference-schedule and --tuned are mutually exclusive")
    config_fn = (reference_schedule_config if args.reference_schedule
                 else tuned_config if args.tuned else None)
    detail = solve_benchmark(args.seed, args.max_epochs, log, config_fn)
    if args.throughput:
        detail["train_env_steps_per_s"] = throughput_benchmark(args.seed)

    value = detail["wall_s"]
    out = {
        "metric": ("pendulum_solve_seconds_reference_schedule"
                   if args.reference_schedule
                   else "pendulum_solve_seconds_tuned" if args.tuned
                   else "pendulum_solve_seconds"),
        "value": round(value, 3),
        "unit": "s",
        "vs_baseline": round(BASELINE_SECONDS / value, 2) if detail["solved"] and value > 0 else 0.0,
        **{k: (round(v, 3) if isinstance(v, float) else v) for k, v in detail.items()},
        "device": rec,
    }
    print(json.dumps(out), flush=True)
    return 0 if detail["solved"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
