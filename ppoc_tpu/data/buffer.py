"""Device-resident trajectory buffer: SoA storage, shuffle, minibatch gather.

Equivalent of the reference ``TrajectoryBuffer``
(``src/trajectory_buffer.cu``, ``include/trajectory_buffer.h:15-79``).  The
reference keeps nine parallel host+device arrays with live pointers swung
between them (create, src/trajectory_buffer.cu:41-94; migration :227-273);
here the buffer is an immutable pytree of ``[rows, ...]`` arrays that never
leaves device memory — rollout, GAE and the update phases all consume it inside one
jitted program, so buffer_to_device/host have no equivalent by design.

Shuffling reproduces the reference's permutation-index scheme
(shuffle_buffer, src/trajectory_buffer.cu:126-166): a fresh permutation per
epoch, sliced into ``n_mb`` index blocks whose tail (< minibatch_size) is
dropped (src/ppo.cu:475-477), gathered with ``jnp.take`` — the XLA twin of
get_batch_kernel (src/trajectory_buffer.cu:168-185).
"""
from __future__ import annotations

from typing import Any, NamedTuple

import jax
import jax.numpy as jnp


class RowBuffer(NamedTuple):
    """Flattened per-transition training rows (the post-GAE buffer)."""
    obs: jax.Array        # [N, obs_dim]
    action: jax.Array     # [N, act_dim]
    log_prob: jax.Array   # [N]
    advantage: jax.Array  # [N]
    target: jax.Array     # [N]  value targets V(s) + A
    v_old: Any = None     # [N]  rollout-time V(s), only materialized when
                          # PPO2 value clipping is on (cfg.clip_value > 0)


def from_rollout(traj, advantage: jax.Array, target: jax.Array,
                 v_old=None) -> RowBuffer:
    """Flatten a [T, E, ...] rollout + GAE outputs into [T*E, ...] rows.

    Equivalent of the reference's single flat ``capacity``-step stream (its
    one env interleaves episodes into 3000 contiguous slots; with E lockstep
    envs the same transitions live in a [T, E] grid).
    """
    n = traj.obs.shape[0] * traj.obs.shape[1]
    return RowBuffer(
        obs=traj.obs.reshape(n, -1),
        action=traj.action.reshape(n, traj.action.shape[-1]),
        log_prob=traj.log_prob.reshape(n),
        advantage=advantage.reshape(n),
        target=target.reshape(n),
        v_old=None if v_old is None else v_old.reshape(n),
    )


def permutation_minibatches(key: jax.Array, n_rows: int, n_mb: int, mb_size: int) -> jax.Array:
    """A fresh shuffle sliced into [n_mb, mb_size] index blocks, tail dropped
    (shuffle_buffer + minibatch loop, src/trajectory_buffer.cu:126-144,
    src/ppo.cu:475-477)."""
    perm = jax.random.permutation(key, n_rows)[: n_mb * mb_size]
    return perm.reshape(n_mb, mb_size)


def block_permutation_minibatches(key: jax.Array, n_rows: int, n_mb: int,
                                  mb_size: int, block: int) -> jax.Array:
    """Minibatch assignment at BLOCK granularity: permute the n_rows/block
    aligned row blocks and deal them into [n_mb, mb_size/block] id slices
    (tail blocks dropped, mirroring the reference's row-level tail drop).

    Rationale: the row-level gather of a large minibatch moves millions
    of rows of a few dozen bytes each, far below the memory system's
    access granularity, so it runs at a small share of the bandwidth.  Block-shuffled minibatches keep every statistical
    property that matters for SGD (each row appears exactly once per
    epoch; assignment to minibatches is uniformly random at block
    resolution) while making the gather a contiguous-block copy that runs
    at bandwidth speed.  Rows within a block stay together across epochs —
    with the [T, E] row layout a block is a slice of envs at one timestep,
    i.e. thousands of independent samples.  Opt-in via
    PPOConfig(shuffle_block): 0 keeps the reference's exact row shuffle.
    """
    n_blocks = n_rows // block
    mb_blocks = mb_size // block
    perm = jax.random.permutation(key, n_blocks)[: n_mb * mb_blocks]
    return perm.reshape(n_mb, mb_blocks)


def gather_blocks(buf: Any, block_ids: jax.Array, block: int) -> Any:
    """Gather [k] aligned row blocks of ``block`` rows each -> k*block rows.

    Each gathered unit is ``block * row_bytes`` contiguous, so this runs at
    memory bandwidth where row-level ``gather`` pays per-row access latency."""
    def one(a):
        blocked = a.reshape((a.shape[0] // block, block) + a.shape[1:])
        out = jnp.take(blocked, block_ids, axis=0)
        return out.reshape((block_ids.shape[0] * block,) + a.shape[1:])

    return jax.tree.map(one, buf)


def gather(buf: Any, idx: jax.Array) -> Any:
    """Gather rows by index from any pytree of row-major arrays
    (get_batch_kernel, src/trajectory_buffer.cu:168-185)."""
    return jax.tree.map(lambda a: jnp.take(a, idx, axis=0), buf)


def epoch_scan(key: jax.Array, n_rows: int, n_mb: int, mb_size: int, mb_step,
               carry, block: int = 0):
    """One shuffled pass over the buffer: scan ``mb_step`` over the gathered
    index blocks (the reference's per-epoch minibatch loop,
    src/ppo.cu:491-533).  ``block > 0`` switches to block-granular shuffling
    (see block_permutation_minibatches) — mb_step then receives block ids
    and must gather with gather_mb(..., block)."""
    if block:
        if n_rows % block or mb_size % block:
            raise ValueError(
                f"shuffle_block ({block}) must divide both the per-shard "
                f"row count ({n_rows}) and minibatch size ({mb_size})"
            )
        idx = block_permutation_minibatches(key, n_rows, n_mb, mb_size, block)
    else:
        idx = permutation_minibatches(key, n_rows, n_mb, mb_size)
    return jax.lax.scan(mb_step, carry, idx)


def gather_mb(buf: Any, idx: jax.Array, block: int = 0) -> Any:
    """Gather one minibatch: row ids (block=0) or block ids (block>0)."""
    return gather_blocks(buf, idx, block) if block else gather(buf, idx)
