"""Seed-parallel training: N independent runs as ONE vmapped device program.

No reference counterpart — the reference trains a single seed per process
(global libc RNG, src/main.c:15-16) — but it is the kind of capability the
whole-program execution model gives for free: the whole train-until-solved program
(ppo.train_until — rollouts, GAE, minibatch epochs, eval, the while loop)
is a pure function of (TrainState, key), so ``jax.vmap`` batches ENTIRE
TRAINING RUNS.  On a card the small reference-scale program underutilizes
(PERF.md), S seeds cost far less than S
sequential runs — cross-seed variance tables (solve_many / train_many) and
hyperparameter grid searches (solve_grid / train_grid: cartesian products
over SWEEPABLE_HPARAMS x seeds, values traced as runtime data) in one
dispatch.

PRNG threading matches ``Trainer`` exactly (PRNGKey(seed) -> split for init
-> split for the run), so a ONE-seed sweep reproduces ``Trainer.solve``'s
epoch count and eval R, with weights equal to float noise
(tests/test_sweep.py).  The vmap batch dim changes XLA's fusion/reduction
order (exactly like any batch-size change), so lanes drift from their
sequential twins at float level — the algorithm, schedules and PRNG
streams are identical.

The sweep runs the float32 XLA path (backend="jnp").  Memory scales with
S — size n_envs accordingly.
"""
from __future__ import annotations

import itertools
from typing import Any, Dict, List, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp

from ppoc_tpu import config, envs
from ppoc_tpu.algo import ppo
from ppoc_tpu.config import PPOConfig

#: Hyperparameters that may vary ACROSS LANES of one compiled grid sweep
#: (solve_grid / train_grid).  These enter the jitted program only through
#: arithmetic, so they can be traced arrays instead of baked constants; the
#: rest of PPOConfig (schedule lengths, gating flags like max_grad_norm or
#: clip_value, mesh sizes) shapes the PROGRAM itself and must stay static.
SWEEPABLE_HPARAMS = (
    "lr_policy", "lr_v", "clip_eps", "ent_coeff", "lam",
    "adam_beta1", "adam_beta2", "adam_eps", "init_std",
)


_JIT_CACHE: Dict[Any, Any] = {}


def _cached_jit(key, builder):
    """Reuse the jitted sweep program across calls: jit's executable cache
    is keyed on the function OBJECT, so rebuilding the closure every call
    would re-trace and re-compile each time — on an accelerator that puts tens of
    seconds of XLA compile inside what callers (bench_scaling
    --sweep) believe is a warmed-up timed region."""
    fn = _JIT_CACHE.get(key)
    if fn is None:
        if len(_JIT_CACHE) > 16:
            _JIT_CACHE.clear()
        fn = _JIT_CACHE[key] = builder()
    return fn


def _backend(cfg: PPOConfig) -> str:
    """Generic-XLA backend string carrying the config's gating options —
    the same top-k the Trainer would use (a bare "jnp" would silently
    degrade sparse MoE routing to dense gating)."""
    if cfg.n_experts > 1:
        from ppoc_tpu.models import mlp

        return mlp.moe_backend("jnp", cfg.moe_topk)
    return "jnp"


def _validate(cfg: PPOConfig, seeds: Sequence[int]) -> None:
    """Config validation for the sweep path: the SAME shared bank Trainer
    runs (config.validate — one definition, no drift) plus the sweep's own
    execution-model constraints (single-device vmapped programs)."""
    if not len(seeds):
        raise ValueError("sweep needs at least one seed")
    config.validate(cfg)
    if cfg.tp_size > 1 or cfg.pp_size > 1 or cfg.ep_size > 1 \
            or cfg.sp_size > 1:
        raise ValueError(
            "sweeps are single-device vmapped programs; tp_size/pp_size/"
            "ep_size/sp_size must be 1"
        )
    if cfg.zero1:
        raise ValueError(
            "zero1 shards optimizer state over a mesh; sweeps are "
            "single-device vmapped programs"
        )
    if cfg.transplant_patience:
        raise ValueError(
            "transplant_patience is a Trainer.train host-loop intervention "
            "(critic->policy encoder transplant on plateau); the sweep's "
            "whole-run vmapped programs cannot perform it — it would be "
            "silently inert here, misreporting trap rates"
        )
    if cfg.fit_dispatch != "fused" or cfg.fits_per_program \
            or cfg.rollout_chunk:
        raise ValueError(
            "sweeps compile whole training runs as single fused programs; "
            "the fit_dispatch/fits_per_program/rollout_chunk chunked "
            "dispatch modes do not apply (and their extreme-window target "
            "regime is beyond a vmapped multi-seed program anyway)"
        )


def _init_states(cfg: PPOConfig, env, seeds: Sequence[int],
                 hp: Optional[Dict[str, jax.Array]] = None):
    """Stacked TrainStates + run keys with Trainer's exact PRNG threading.

    ``hp`` maps SWEEPABLE_HPARAMS names to [G] value arrays; each lane's
    state is initialized under its own overlaid config (init_std is the one
    hyperparameter that shapes initialization)."""
    keys = jnp.stack([jax.random.PRNGKey(int(s)) for s in seeds])
    k_init, k_run = jax.vmap(lambda k: tuple(jax.random.split(k)))(keys)
    if hp:
        states = jax.vmap(
            lambda k, h: ppo.init_train_state(cfg.replace(**h), env, k)
        )(k_init, hp)
    else:
        states = jax.vmap(lambda k: ppo.init_train_state(cfg, env, k))(k_init)
    return states, k_run


def _expand_grid(
    axes: Dict[str, Sequence[float]], seeds: Sequence[int]
) -> Tuple[Tuple[str, ...], Dict[str, jax.Array], List[int], List[Dict[str, Any]]]:
    """Cartesian product of hyperparameter axes x seeds -> flat lanes.

    Returns (names, {name: [G] f32 array}, [G] seed list, [G] combo dicts).
    """
    if not axes:
        raise ValueError("grid sweep needs at least one hyperparameter axis")
    names = tuple(sorted(axes))
    for n in names:
        if n not in SWEEPABLE_HPARAMS:
            raise ValueError(
                f"{n!r} is not grid-sweepable; lanes of one compiled program "
                f"can only vary {SWEEPABLE_HPARAMS} (schedule/gating/mesh "
                f"fields shape the program itself — run those as separate "
                f"configs)"
            )
        if not len(axes[n]):
            raise ValueError(f"grid axis {n!r} is empty")
    combos: List[Dict[str, Any]] = []
    for values in itertools.product(*(axes[n] for n in names)):
        for s in seeds:
            combos.append(dict(zip(names, map(float, values)), seed=int(s)))
    hp = {
        n: jnp.asarray([c[n] for c in combos], jnp.float32) for n in names
    }
    return names, hp, [c["seed"] for c in combos], combos


def solve_many(cfg: PPOConfig, seeds: Sequence[int], target_R: float,
               max_epochs: int = 100) -> Dict[str, Any]:
    """Train every seed until eval R >= ``target_R`` — one jitted dispatch.

    The vmapped ``lax.while_loop`` iterates until the SLOWEST seed solves
    (finished seeds' updates are masked by the batching rule), so wall-clock
    follows max(epochs) while the chip stays busy on all S programs.

    Returns {"epochs": [S], "R": [S], "states": stacked TrainState}.
    """
    _validate(cfg, seeds)
    env = envs.make_for(cfg)
    backend = _backend(cfg)
    states, k_run = _init_states(cfg, env, seeds)

    def one(ts, key):
        k, _ = jax.random.split(key)
        return ppo.train_until(cfg, env, ts, k, target_R=target_R,
                               max_epochs=max_epochs, backend=backend)

    run = _cached_jit(("solve", cfg, target_R, max_epochs),
                      lambda: jax.jit(jax.vmap(one)))
    new_states, n, R = run(states, k_run)
    n, R = jax.device_get((n, R))
    return {"epochs": [int(x) for x in n], "R": [float(x) for x in R],
            "states": new_states}


def train_many(cfg: PPOConfig, seeds: Sequence[int],
               n_epochs: Optional[int] = None) -> Dict[str, Any]:
    """Fixed-schedule sweep: per-seed learning curves in one dispatch.

    Returns {"R": [S, n_epochs], "J": [S, n_epochs], "entropy": [S, n_epochs],
    "states": stacked TrainState} — the raw material for cross-seed
    variance tables.
    """
    n_epochs = cfg.n_epochs if n_epochs is None else n_epochs
    _validate(cfg, seeds)
    env = envs.make_for(cfg)
    backend = _backend(cfg)
    states, k_run = _init_states(cfg, env, seeds)

    def one(ts, key):
        def epoch(carry, _):
            ts, key = carry
            key, k_train, k_eval = jax.random.split(key, 3)
            ts, metrics = ppo.train_epoch(cfg, env, ts, k_train,
                                          backend=backend)
            ev = ppo.evaluate(cfg, env, ts.policy_params, k_eval, backend)
            return (ts, key), (ev.R, ev.J, metrics.entropy)

        (ts, _), (R, J, ent) = jax.lax.scan(
            epoch, (ts, key), None, length=n_epochs)
        return ts, R, J, ent

    run = _cached_jit(("train", cfg, n_epochs),
                      lambda: jax.jit(jax.vmap(one)))
    new_states, R, J, ent = run(states, k_run)
    R, J, ent = jax.device_get((R, J, ent))
    return {"R": R, "J": J, "entropy": ent, "states": new_states}


# --------------------------------------------------------------------------
# hyperparameter grids: lanes vary (lr, clip_eps, ent_coeff, ...) x seeds
# --------------------------------------------------------------------------

def solve_grid(cfg: PPOConfig, axes: Dict[str, Sequence[float]],
               target_R: float, seeds: Sequence[int] = (0,),
               max_epochs: int = 100) -> Dict[str, Any]:
    """Hyperparameter grid search as ONE vmapped train-until program.

    ``axes`` maps SWEEPABLE_HPARAMS names to value lists; every combination
    in their cartesian product crossed with ``seeds`` trains as one lane of
    a single compiled dispatch.  The swept values enter the program as
    RUNTIME DATA (traced scalars), not baked constants, so re-running with
    different values — e.g. zooming the grid around the best lane — reuses
    the compiled executable as long as the axis names and lane count match.

    Returns {"combos": [G] list of {name: value, "seed": s},
    "epochs": [G], "R": [G], "states": stacked TrainState,
    "best": index of the lane with the fewest epochs (ties: highest R)}.
    """
    _validate(cfg, seeds)
    names, hp, seed_list, combos = _expand_grid(axes, seeds)
    env = envs.make_for(cfg)
    backend = _backend(cfg)
    states, k_run = _init_states(cfg, env, seed_list, hp)

    def one(ts, key, h):
        k, _ = jax.random.split(key)
        return ppo.train_until(cfg.replace(**h), env, ts, k,
                               target_R=target_R, max_epochs=max_epochs,
                               backend=backend)

    run = _cached_jit(("solve-grid", cfg, names, len(combos), target_R,
                       max_epochs), lambda: jax.jit(jax.vmap(one)))
    new_states, n, R = run(states, k_run, hp)
    n, R = jax.device_get((n, R))
    epochs = [int(x) for x in n]
    rs = [float(x) for x in R]
    best = min(range(len(combos)), key=lambda i: (epochs[i], -rs[i]))
    return {"combos": combos, "epochs": epochs, "R": rs,
            "states": new_states, "best": best}


def train_grid(cfg: PPOConfig, axes: Dict[str, Sequence[float]],
               seeds: Sequence[int] = (0,),
               n_epochs: Optional[int] = None) -> Dict[str, Any]:
    """Fixed-schedule hyperparameter grid: per-lane learning curves in one
    dispatch (the grid counterpart of :func:`train_many`).

    Returns {"combos": [G], "R": [G, n_epochs], "J": [G, n_epochs],
    "entropy": [G, n_epochs], "states": stacked TrainState}.
    """
    n_epochs = cfg.n_epochs if n_epochs is None else n_epochs
    _validate(cfg, seeds)
    names, hp, seed_list, combos = _expand_grid(axes, seeds)
    env = envs.make_for(cfg)
    backend = _backend(cfg)
    states, k_run = _init_states(cfg, env, seed_list, hp)

    def one(ts, key, h):
        cfg_h = cfg.replace(**h)

        def epoch(carry, _):
            ts, key = carry
            key, k_train, k_eval = jax.random.split(key, 3)
            ts, metrics = ppo.train_epoch(cfg_h, env, ts, k_train,
                                          backend=backend)
            ev = ppo.evaluate(cfg_h, env, ts.policy_params, k_eval, backend)
            return (ts, key), (ev.R, ev.J, metrics.entropy)

        (ts, _), (R, J, ent) = jax.lax.scan(
            epoch, (ts, key), None, length=n_epochs)
        return ts, R, J, ent

    run = _cached_jit(("train-grid", cfg, names, len(combos), n_epochs),
                      lambda: jax.jit(jax.vmap(one)))
    new_states, R, J, ent = run(states, k_run, hp)
    R, J, ent = jax.device_get((R, J, ent))
    return {"combos": combos, "R": R, "J": J, "entropy": ent,
            "states": new_states}
