"""Recall: a minimal memory task for the recurrent model family.

No reference counterpart (the reference's envs are fully observed,
src/env.c, scripts/gym_env.py) — this is the partially-observable analogue
of the ``simple`` smoke-test env: at reset a random cue bit b in {-1, +1}
is SHOWN ONCE in the first observation, every later observation is blank,
and the only reward is 1.0 at the final step iff the action's sign matches
the cue.

The diagnostic property: a memoryless (MLP) policy sees the blank final
observation and can only guess — its best expected return is 0.5 — while a
recurrent policy that carries the cue scores ~1.0.  tests/test_rnn.py uses
exactly this gap as the learning differentiator.

Observation layout: [cue (b at t=0, else 0), is_first_step flag].
"""
from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from .core import Env, EnvSpec, register

HORIZON = 6


class RecallState(NamedTuple):
    b: jax.Array  # f32 scalar cue in {-1, +1}
    t: jax.Array  # i32 step count


def _obs(st: RecallState) -> jax.Array:
    first = (st.t == 0).astype(jnp.float32)
    return jnp.stack([st.b * first, first])


def _reset(key: jax.Array):
    b = jnp.where(jax.random.bernoulli(key), 1.0, -1.0)
    st = RecallState(b, jnp.zeros((), jnp.int32))
    return st, _obs(st)


def _make_step(horizon: int):
    def _step(st: RecallState, action: jax.Array, key: jax.Array):
        del key
        t = st.t + 1
        last = t >= horizon
        reward = jnp.where(
            jnp.logical_and(last, st.b * action[0] > 0.0), 1.0, 0.0)
        st2 = RecallState(st.b, t)
        return st2, _obs(st2), reward, last, jnp.zeros((), bool)

    return _step


_step = _make_step(HORIZON)


def _make_recall(name: str, horizon: int) -> Env:
    spec = EnvSpec(
        name=name,
        obs_dim=2,
        action_dim=1,
        horizon=horizon,
        gamma=0.99,
        action_low=-1.0,
        action_high=1.0,
    )
    return Env(spec=spec, reset=_reset, step=_make_step(horizon))


@register("recall")
def make_recall() -> Env:
    return _make_recall("recall", HORIZON)


@register("recall_long")
def make_recall_long() -> Env:
    """512-step recall: the LONG-CONTEXT differentiator.  The cue is 511
    steps in the past at answer time — a one-hop attention lookup over the
    window but a 511-step carry for a recurrent cell's BPTT."""
    return _make_recall("recall_long", 512)


@register("recall_xl")
def make_recall_xl() -> Env:
    """1024-step recall: a window where training's attention runs the
    flash kernel on a GPU (T >= models/attn.FLASH_MIN_T,
    ops/flash_attn.py)."""
    return _make_recall("recall_xl", 1024)


@register("recall_xxl")
def make_recall_xxl() -> Env:
    """2048-step recall: the long-window stress variant (train + serve at
    T=2048, examples/recall_xl_curriculum.py taken one doubling further)."""
    return _make_recall("recall_xxl", 2048)


@register("recall_4k")
def make_recall_4k() -> Env:
    """4096-step recall: a 4095-step retrieval distance, every parallel
    pass through the 512-tile flash kernel."""
    return _make_recall("recall_4k", 4096)


@register("recall_8k")
def make_recall_8k() -> Env:
    """8192-step recall: an 8191-step retrieval distance (trained + served
    round 5)."""
    return _make_recall("recall_8k", 8192)


@register("recall_16k")
def make_recall_16k() -> Env:
    """16384-step recall: the top of the window-doubling curriculum."""
    return _make_recall("recall_16k", 16384)
