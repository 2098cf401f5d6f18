"""Pure-functional environment interface.

Replacement for the reference's vtable env abstraction
(``include/env.h:7-15``) and the embedded-CPython Gymnasium bridge
(``src/gym_env.c``, ``scripts/gym_env.py``).  Instead of host function
pointers called once per step, an environment here is a pair of pure
functions on explicit state, so thousands of instances can be stepped in
lockstep under ``vmap`` + ``jit`` entirely on device.

Conventions:
  * ``reset(key) -> (state, obs)``
  * ``step(state, action, key) -> (state, obs, reward, terminated, truncated)``
  * ``state`` is an arbitrary pytree that includes whatever step counter the
    env needs for its own time-limit truncation.
  * ``terminated`` / ``truncated`` are bool scalars with Gymnasium semantics:
    terminated = MDP end (bootstrap with V=0), truncated = time limit
    (bootstrap with V(s')).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Tuple

import jax
import jax.numpy as jnp


@dataclasses.dataclass(frozen=True)
class EnvSpec:
    name: str
    obs_dim: int
    action_dim: int
    horizon: int          # max_episode_steps (truncation limit)
    gamma: float          # env-owned discount, as in include/env.h:13
    discrete: bool = False
    action_low: float = -1.0
    action_high: float = 1.0


@dataclasses.dataclass(frozen=True)
class Env:
    spec: EnvSpec
    reset: Callable[[jax.Array], Tuple[Any, jax.Array]]
    step: Callable[[Any, jax.Array, jax.Array], Tuple[Any, jax.Array, jax.Array, jax.Array, jax.Array]]


_REGISTRY: Dict[str, Callable[[], Env]] = {}


def register(name: str):
    def deco(factory):
        _REGISTRY[name] = factory
        return factory
    return deco


def make(name: str, **kwargs) -> Env:
    if name not in _REGISTRY:
        raise KeyError(f"unknown env '{name}'; available: {sorted(_REGISTRY)}")
    return _REGISTRY[name](**kwargs)


def registry() -> Dict[str, Callable[[], Env]]:
    return dict(_REGISTRY)


# --- vectorization ---------------------------------------------------------

def vector_reset(env: Env, key: jax.Array, n_envs: int):
    """Reset ``n_envs`` independent instances; returns batched (state, obs)."""
    keys = jax.random.split(key, n_envs)
    return jax.vmap(env.reset)(keys)


def vector_step(env: Env, state, action: jax.Array, key: jax.Array):
    """Step a batch of env instances in lockstep."""
    n = action.shape[0]
    keys = jax.random.split(key, n)
    return jax.vmap(env.step)(state, action, keys)


def vector_autoreset_step(env: Env, state, action: jax.Array, key: jax.Array):
    """Step, then reset any instance that finished.

    Returns ``(state', obs', next_obs, reward, terminated, truncated)`` where
    ``next_obs`` is the true successor observation (used for GAE
    bootstrapping) and ``obs'`` is the observation the policy acts on next
    (fresh-reset obs where done).  This reproduces the reference rollout's
    branch at src/ppo.cu:64-69.
    """
    n = action.shape[0]
    kstep, kreset = jax.random.split(key)
    new_state, next_obs, reward, terminated, truncated = vector_step(env, state, action, kstep)
    done = jnp.logical_or(terminated, truncated)
    reset_state, reset_obs = vector_reset(env, kreset, n_envs=n)

    def pick(fresh, kept):
        mask = done.reshape(done.shape + (1,) * (kept.ndim - 1))
        return jnp.where(mask, fresh, kept)

    state_out = jax.tree.map(pick, reset_state, new_state)
    obs_out = pick(reset_obs, next_obs)
    return state_out, obs_out, next_obs, reward, terminated, truncated
