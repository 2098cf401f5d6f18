"""GAE(lambda) as a parallel associative scan over the time axis.

Equivalent of the reference's two-level block-parallel CUDA scan
(``gae_compute_block_advantage_kernel`` src/ppo.cu:171-213 and
``gae_merge_kernel`` src/ppo.cu:215-251) and of the CPU backward recursion
(src/ppo.cu:326-369).  The masked first-order recurrence

    A_t = delta_t + gamma*lam * not(terminated_t | truncated_t) * A_{t+1}
    delta_t = r_t + gamma * V(s_{t+1}) * not(terminated_t) - V(s_t)

is a linear recurrence, hence associative: ``jax.lax.associative_scan``
compiles it to a log-depth scan that XLA tiles over the VPU — the same
algorithmic idea as the reference's doubling scan, expressed to the compiler
instead of hand-scheduled.  Time is laid out per environment ([T, E]), so the
scan never crosses devices when E is sharded.

``gae_reference`` is the O(T) sequential twin kept for cross-checking, the
same role the reference's CPU path plays for its CUDA kernels.
"""
from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp


def _linrec_combine(a, b):
    """Combine two elements of the suffix linear recurrence.

    An element (c, d) denotes the affine map A -> d + c*A.  Combining in scan
    order (toward earlier time) composes: first apply the later element, then
    this one.
    """
    c1, d1 = a
    c2, d2 = b
    return c1 * c2, d2 + c2 * d1


def gae(
    rewards: jax.Array,      # [T, ...]
    values: jax.Array,       # [T, ...]  V(s_t)
    next_values: jax.Array,  # [T, ...]  V(s_{t+1})
    terminated: jax.Array,   # [T, ...]  bool
    truncated: jax.Array,    # [T, ...]  bool
    gamma: float,
    lam: float,
) -> Tuple[jax.Array, jax.Array]:
    """Return (advantages, value_targets), both shaped like ``rewards``.

    ``value_targets = V(s) + A`` as in src/ppo.cu:352 (computed before any
    advantage normalization).
    """
    term = terminated.astype(rewards.dtype)
    done = jnp.logical_or(terminated, truncated).astype(rewards.dtype)
    delta = rewards + gamma * next_values * (1.0 - term) - values
    coeff = gamma * lam * (1.0 - done)

    # Reverse time, run the prefix linear-recurrence scan, reverse back.
    c = jnp.flip(coeff, axis=0)
    d = jnp.flip(delta, axis=0)
    _, adv_rev = jax.lax.associative_scan(_linrec_combine, (c, d), axis=0)
    adv = jnp.flip(adv_rev, axis=0)
    return adv, values + adv


def gae_reference(rewards, values, next_values, terminated, truncated, gamma, lam):
    """Sequential O(T) twin of :func:`gae` (mirrors src/ppo.cu:338-353)."""
    term = terminated.astype(rewards.dtype)
    done = jnp.logical_or(terminated, truncated).astype(rewards.dtype)
    delta = rewards + gamma * next_values * (1.0 - term) - values
    coeff = gamma * lam * (1.0 - done)

    def body(carry, xs):
        d, c = xs
        a = d + c * carry
        return a, a

    _, adv_rev = jax.lax.scan(
        body,
        jnp.zeros_like(rewards[0]),
        (jnp.flip(delta, 0), jnp.flip(coeff, 0)),
    )
    adv = jnp.flip(adv_rev, 0)
    return adv, values + adv


def discounted_episode_returns(rewards: jax.Array, done: jax.Array, gamma: float) -> jax.Array:
    """Per-step suffix returns that reset at episode boundaries.

    J_t = r_t + gamma * not(done_t) * J_{t+1} — the recurrence behind the
    reference's eval loop (src/ppo.cu:571-579), vectorized.  ``done_t`` marks
    the *last* step of an episode.
    """
    coeff = gamma * (1.0 - done.astype(rewards.dtype))
    c = jnp.flip(coeff, 0)
    d = jnp.flip(rewards, 0)
    _, j_rev = jax.lax.associative_scan(_linrec_combine, (c, d), axis=0)
    return jnp.flip(j_rev, 0)


def normalize(x: jax.Array, mean: jax.Array, std: jax.Array, eps: float = 1e-8) -> jax.Array:
    """(x - mean) / (std + eps), the reference's normalize_advantage_kernel
    (src/ppo.cu:253-259)."""
    return (x - mean) / (std + eps)
