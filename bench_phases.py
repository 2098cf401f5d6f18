"""Perf X-ray: fit-phase time breakdown + achieved FLOP/s on the GPU.

Splits the jitted training epoch into its four phases — rollout, GAE +
advantage normalization, value epochs, policy epochs — times each as its own
jitted program (host clock around ``jax.block_until_ready``), and reports
analytic MLP FLOPs and their share of the card's dense bf16 tensor-core
peak (PEAKS, keyed by ``device_kind``).

Usage:  python bench_phases.py [--config bench|throughput|reacher|all]
                               [--backend jnp|bf16]
Prints one JSON line per config, naming its device; progress to stderr.
Refuses to run without a GPU, and on a card missing from PEAKS.
"""
from __future__ import annotations

import argparse
import functools
import json
import sys
import time

import jax

from ppoc_tpu import envs
from ppoc_tpu.algo import ppo
from ppoc_tpu.config import PPOConfig, throughput_preset
from ppoc_tpu.data import buffer
from ppoc_tpu.utils import device
from ppoc_tpu.utils.cache import enable_compilation_cache

# Published dense peaks, keyed by jax device_kind.  Source: NVIDIA H100
# Tensor Core GPU data sheet (SXM5 part, dense, no sparsity), at the full
# 700 W power limit; a card set lower reaches less.
PEAKS = {
    "NVIDIA H100 80GB HBM3": {"bf16_flops": 989e12, "tf32_flops": 495e12,
                              "fp32_flops": 67e12, "hbm_bytes_s": 3.35e12},
}


def peak_bf16(device_kind: str) -> float:
    if device_kind not in PEAKS:
        raise KeyError(f"no published peaks for device {device_kind!r}; "
                       f"add it to bench_phases.PEAKS with its source")
    return PEAKS[device_kind]["bf16_flops"]


def configs():
    from bench import bench_config

    return {
        "bench": bench_config(0),
        "throughput": throughput_preset("pendulum", 0),
        "reacher": PPOConfig(env="reacher", n_envs=4096, rollout_len=150,
                             minibatch_size=16384, fits_per_epoch=1,
                             hidden=(256, 256), eval_envs=256, eval_len=150),
    }


def mlp_flops(sizes, batch):
    """Forward FLOPs of one dense pass over ``batch`` rows."""
    return 2 * batch * sum(a * b for a, b in zip(sizes[:-1], sizes[1:]))


def time_fn(fn, *args, reps=10, warmup=3):
    for _ in range(warmup):
        jax.block_until_ready(fn(*args))
    t0 = time.perf_counter()
    for _ in range(reps):
        out = fn(*args)
    jax.block_until_ready(out)
    return (time.perf_counter() - t0) / reps


def xray(name: str, cfg: PPOConfig, backend: str, peak: float, log) -> dict:
    env = envs.make(cfg.env)
    key = jax.random.PRNGKey(0)
    ts = ppo.init_train_state(cfg, env, key)
    spec = env.spec
    pol_sizes = (spec.obs_dim, *cfg.hidden, spec.action_dim)
    v_sizes = (spec.obs_dim, *cfg.hidden, 1)
    T, E, mb, n_mb = cfg.rollout_len, cfg.n_envs, cfg.minibatch_size, cfg.num_minibatches

    # --- phase programs -----------------------------------------------------
    roll = jax.jit(functools.partial(
        ppo.rollout, cfg, env, n_envs=E, length=T, backend=backend))
    traj, _ = jax.block_until_ready(roll(ts.policy_params, key))

    adv_fn = jax.jit(functools.partial(
        ppo.compute_advantages, cfg, env, axis_name=None, backend=backend))
    adv, target = adv_fn(ts.v_params, traj)
    buf = buffer.from_rollout(traj, adv, target)

    val_fn = jax.jit(lambda ts_, k: ppo.value_phase(
        cfg, ts_, buf, k, None, backend, n_mb, mb))
    pol_fn = jax.jit(lambda ts_, k: ppo.policy_phase(
        cfg, env, ts_, buf, k, None, backend, n_mb, mb))
    fit_fn = jax.jit(functools.partial(
        ppo.fit_step, cfg, env, backend=backend))

    t_roll = time_fn(lambda: roll(ts.policy_params, key))
    t_adv = time_fn(lambda: adv_fn(ts.v_params, traj))
    t_val = time_fn(lambda: val_fn(ts, key))
    t_pol = time_fn(lambda: pol_fn(ts, key))
    t_fit = time_fn(lambda: fit_fn(ts, key))

    # --- analytic FLOPs per fit --------------------------------------------
    f_roll = T * mlp_flops(pol_sizes, E)                       # policy fwd/step
    f_adv = 2 * mlp_flops(v_sizes, T * E)                      # V(s), V(s')
    f_val = cfg.n_epochs_value * n_mb * 3 * mlp_flops(v_sizes, mb)   # fwd+bwd
    f_pol = cfg.n_epochs_policy * n_mb * 3 * mlp_flops(pol_sizes, mb)
    f_fit = f_roll + f_adv + f_val + f_pol

    def row(t, f):
        return {"ms": round(t * 1e3, 3), "gflop": round(f / 1e9, 3),
                "pct_of_bf16_peak": round(100 * f / t / peak, 3),
                "pct_of_fit": round(100 * t / (t_roll + t_adv + t_val + t_pol), 1)}

    out = {
        "config": name,
        "backend": backend,
        "steps_per_fit": cfg.steps_per_fit,
        "rollout": row(t_roll, f_roll),
        "gae_norm": row(t_adv, f_adv),
        "value_phase": row(t_val, f_val),
        "policy_phase": row(t_pol, f_pol),
        "full_fit_ms": round(t_fit * 1e3, 3),
        "phase_sum_ms": round((t_roll + t_adv + t_val + t_pol) * 1e3, 3),
        "fit_pct_of_bf16_peak": round(100 * f_fit / t_fit / peak, 3),
        "env_steps_per_s": round(cfg.steps_per_fit / t_fit),
    }
    log(f"{name}/{backend}: fit {out['full_fit_ms']}ms "
        f"(roll {out['rollout']['ms']} | gae {out['gae_norm']['ms']} | "
        f"val {out['value_phase']['ms']} | pol {out['policy_phase']['ms']}) "
        f"{out['fit_pct_of_bf16_peak']}% of bf16 peak")
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", default="all",
                    choices=["bench", "throughput", "reacher", "all"])
    ap.add_argument("--backend", default="jnp", choices=["jnp", "bf16"])
    ap.add_argument("--shuffle-block", type=int, default=0,
                    help="block-shuffled minibatches at this granularity "
                         "(PPOConfig.shuffle_block)")
    args = ap.parse_args(argv)
    log = lambda *a: print(*a, file=sys.stderr, flush=True)
    enable_compilation_cache()
    rec = device.require_gpu()
    peak = peak_bf16(rec["device_kind"])

    all_cfgs = configs()
    names = list(all_cfgs) if args.config == "all" else [args.config]
    for n in names:
        cfg = all_cfgs[n]
        if args.shuffle_block:
            cfg = cfg.replace(shuffle_block=args.shuffle_block)
        print(json.dumps({**xray(n, cfg, args.backend, peak, log),
                          "device": rec}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
