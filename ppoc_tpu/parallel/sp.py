"""Sequence parallelism: GAE over a TIME-sharded trajectory buffer.

The reference's only sequence-length machinery is the GAE scan over time
(block-parallel doubling scan, src/ppo.cu:171-251, merged across blocks by
``gae_merge_kernel`` src/ppo.cu:215-251 — its "cross-block merge" is exactly
the cross-DEVICE merge implemented here, one level up the memory hierarchy).
SURVEY.md §2a maps sequence/context parallelism to "GAE over the time axis";
ops/gae.py covers the time-local case (time never crosses devices when only
envs are sharded).  This module covers the other layout: rollouts whose
horizon is long enough that the [T, E] buffer itself shards over time across
an ``sp`` mesh axis — the long-context regime.

The masked GAE recurrence is a suffix-ordered linear (affine) recurrence,

    A_t = delta_t + coeff_t * A_{t+1},   coeff_t = gamma*lam*(1-done_t),

so a time shard [T/N, ...] is itself an affine map acting on the carry
arriving from the NEXT shard (later in time):

    A(first step of shard) = D_shard + C_shard * A_in,
    C_shard = prod_t coeff_t,   D_shard = local suffix scan with zero carry.

Per device: one local log-depth ``associative_scan`` (same kernel as the
unsharded path) plus a suffix product of coeffs; across devices: ONE
``all_gather`` over ``sp`` of the tiny per-shard (C, D) pair ([E]-shaped, N
pairs), after which every device composes the N affine maps in a log-N
``associative_scan`` and applies its own incoming carry.  Comm volume is
2*N*E floats — independent of T, so the horizon can grow arbitrarily while
the collective stays fixed-size.

Exactness: the local scan and the cross-shard combine use the same
``_linrec_combine`` as ops/gae.py, so the sharded result matches the
single-device scan up to f32 reassociation noise (tests/test_sp.py pins
this at 1e-5 and checks the sequential O(T) reference too).
"""
from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp

from ppoc_tpu.ops.gae import _linrec_combine


def gae_sp(
    rewards: jax.Array,      # [T_local, ...] this device's time shard
    values: jax.Array,       # [T_local, ...] V(s_t)
    next_values: jax.Array,  # [T_local, ...] V(s_{t+1})
    terminated: jax.Array,   # [T_local, ...] bool
    truncated: jax.Array,    # [T_local, ...] bool
    gamma: float,
    lam: float,
    axis_name: str = "sp",
) -> Tuple[jax.Array, jax.Array]:
    """Time-sharded GAE: call inside ``shard_map`` with time split over
    ``axis_name``.  Shard i must hold the time-contiguous slice
    ``[i*T/N, (i+1)*T/N)`` (jax.sharding's default layout for a
    ``P("sp", ...)`` array).  Returns (advantages, value_targets) for the
    local shard, identical to running :func:`ppoc_tpu.ops.gae.gae` on the
    gathered buffer.
    """
    term = terminated.astype(rewards.dtype)
    done = jnp.logical_or(terminated, truncated).astype(rewards.dtype)
    delta = rewards + gamma * next_values * (1.0 - term) - values
    coeff = gamma * lam * (1.0 - done)

    # Local suffix scan with zero incoming carry (reverse, prefix-scan,
    # reverse — the unsharded kernel on this shard), keeping the running
    # coefficient product: after the scan, position t holds
    # (P_t, a_t) with P_t = prod_{s>=t} coeff_s and
    # a_t = suffix-GAE of the local shard alone, i.e. the local advantage
    # assuming A_in = 0.  The true advantage is A_t = a_t + P_t * A_in.
    c_rev = jnp.flip(coeff, axis=0)
    d_rev = jnp.flip(delta, axis=0)
    prod_rev, adv_rev = jax.lax.associative_scan(
        _linrec_combine, (c_rev, d_rev), axis=0
    )
    local_adv0 = jnp.flip(adv_rev, axis=0)    # a_t
    suffix_prod = jnp.flip(prod_rev, axis=0)  # P_t

    # This shard's whole-shard affine map: A_first = D + C * A_in.
    c_shard = suffix_prod[0]
    d_shard = local_adv0[0]

    # Cross-device merge: gather all N (C, D) pairs (tiny — [N, E] each),
    # compose suffix-ward, and read off this shard's incoming carry = the
    # advantage at the first step of shard i+1 (zero for the last shard).
    n = jax.lax.axis_size(axis_name)
    i = jax.lax.axis_index(axis_name)
    cs = jax.lax.all_gather(c_shard, axis_name)  # [N, ...]
    ds = jax.lax.all_gather(d_shard, axis_name)
    # Suffix-compose: flip shard order (later shards first), prefix-scan with
    # the same combine, flip back.  comp[j] = advantage at the first step of
    # shard j given zero carry after the last shard.
    _, comp_rev = jax.lax.associative_scan(
        _linrec_combine, (jnp.flip(cs, 0), jnp.flip(ds, 0)), axis=0
    )
    comp = jnp.flip(comp_rev, 0)
    # Incoming carry for shard i = comp[i+1]; last shard gets 0.  Pad with a
    # zero row so the gather is branch-free under jit.
    comp_pad = jnp.concatenate([comp, jnp.zeros_like(comp[:1])], axis=0)
    a_in = jax.lax.dynamic_index_in_dim(
        comp_pad, jnp.minimum(i + 1, n), axis=0, keepdims=False
    )

    adv = local_adv0 + suffix_prod * a_in
    return adv, values + adv
