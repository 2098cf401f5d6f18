"""Learning-curve parity: reference schedule on a data-parallel mesh.

BASELINE.md row 3 demands learning curves that match the reference within
seed variance on 1 chip AND on an N>=2 mesh.  This harness runs the exact
reference schedule (15 envs x 200-step fits, minibatch 64 — src/main.c:33-43)
single-device and sharded over an 8-device mesh for several seeds, and
prints the per-epoch eval R for both, plus the first-solve epochs.

Without 8 GPUs the mesh leg runs on 8 virtual CPU devices (the sharded
program is identical; only the interconnect is fake):

    python bench_parity.py --platform cpu --devices 8 --seeds 3

Prints one JSON line with the curves; progress to stderr.
"""
from __future__ import annotations

import argparse
import json
import sys

from ppoc_tpu.utils import device


def run(platform, n_devices, seeds, epochs):
    import jax

    if platform:
        jax.config.update("jax_platforms", platform)
        if platform == "cpu" and n_devices:
            jax.config.update("jax_num_cpu_devices", n_devices)

    from ppoc_tpu.algo.trainer import Trainer
    from ppoc_tpu.config import PPOConfig
    from ppoc_tpu.parallel import make_mesh

    log = lambda *a: print(*a, file=sys.stderr, flush=True)
    curves = {"single": {}, "mesh": {}}
    # n_envs=16 (vs the reference's 15) so envs/minibatches split evenly over
    # 8 shards; steps_per_fit 3200 vs 3000, same minibatch 64 and epochs
    base = dict(env="pendulum", n_envs=16, rollout_len=200, minibatch_size=64,
                fits_per_epoch=10, eval_envs=16, eval_len=200,
                kernel_backend="jnp")
    for seed in range(seeds):
        for leg, mesh in (("single", None), ("mesh", make_mesh(n_devices))):
            tr = Trainer(PPOConfig(**base, seed=seed), mesh=mesh)
            hist = tr.train(n_epochs=epochs, log=False)
            rs = [round(h["R"], 1) for h in hist]
            solve = next((i for i, r in enumerate(rs) if r >= -200), None)
            curves[leg][seed] = {"R": rs, "first_solve_epoch": solve}
            log(f"seed {seed} {leg}: {rs} solve@{solve}")
    return curves


def run_estimator_parity(platform, epochs):
    """Curve parity under BOTH eval estimators: per epoch,
    evaluate the SAME policy on the SAME eval rollout (same key) with the
    default completed-episodes estimator and the strict reference one
    (src/ppo.cu:560-583).  Pendulum (horizon == eval window): the two R
    columns agree exactly.  CartPole at eval_len=200 < horizon 500: the
    reference estimator counts window-cut segments and deflates R — the
    deviation the default exists to fix, now measured per epoch."""
    import functools

    import jax

    if platform:
        jax.config.update("jax_platforms", platform)

    from ppoc_tpu import envs
    from ppoc_tpu.algo import ppo
    from ppoc_tpu.algo.trainer import Trainer
    from ppoc_tpu.config import PPOConfig

    log = lambda *a: print(*a, file=sys.stderr, flush=True)
    out = {}
    base = dict(n_envs=16, rollout_len=200, minibatch_size=64,
                fits_per_epoch=10, eval_envs=16, eval_len=200,
                kernel_backend="jnp", seed=0)
    for env_name in ("pendulum", "cartpole"):
        cfg = PPOConfig(env=env_name, **base)
        env = envs.make_for(cfg)
        tr = Trainer(cfg)
        ev = {
            est: jax.jit(functools.partial(
                ppo.evaluate, cfg.replace(eval_estimator=est), env,
                backend="jnp", n_envs=cfg.eval_envs))
            for est in ("completed", "reference")
        }
        rows = []
        for ep in range(epochs):
            tr.train_epoch()
            k = jax.random.PRNGKey(1000 + ep)   # same rollout for both
            mc = jax.device_get(ev["completed"](tr.state.policy_params, k))
            mr = jax.device_get(ev["reference"](tr.state.policy_params, k))
            rows.append({"epoch": ep,
                         "R_completed": round(float(mc.R), 2),
                         "R_reference": round(float(mr.R), 2),
                         "eps_completed": int(mc.episodes),
                         "eps_reference": int(mr.episodes)})
            log(f"{env_name} ep{ep}: completed R={rows[-1]['R_completed']} "
                f"({rows[-1]['eps_completed']} eps) | reference "
                f"R={rows[-1]['R_reference']} ({rows[-1]['eps_reference']})")
        out[env_name] = rows
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--platform", default=None, choices=["cpu", "gpu"])
    ap.add_argument("--devices", type=int, default=8)
    ap.add_argument("--seeds", type=int, default=3)
    ap.add_argument("--epochs", type=int, default=14)
    ap.add_argument("--estimator-parity", action="store_true",
                    help="per-epoch R under the completed vs the strict "
                         "reference estimator (same policy, same rollout)")
    args = ap.parse_args(argv)
    if args.estimator_parity:
        rows = run_estimator_parity(args.platform, args.epochs)
        print(json.dumps({"metric": "estimator_parity", "curves": rows,
                          "device": device.record()}), flush=True)
        return 0
    curves = run(args.platform, args.devices, args.seeds, args.epochs)
    solves = {leg: [v["first_solve_epoch"] for v in by_seed.values()]
              for leg, by_seed in curves.items()}
    print(json.dumps({"metric": "curve_parity_reference_schedule",
                      "first_solve_epochs": solves, "curves": curves,
                      "device": device.record()}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
