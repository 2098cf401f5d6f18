"""Ring attention: causal episode-masked attention over a time-sharded mesh.

The single-device long-window path is the flash kernel (ops/flash_attn.py);
past one device's memory the window itself must shard.  This module is the
cross-DEVICE long-context axis: the [T, B] window splits into contiguous
time blocks over an ``sp`` mesh axis (the same axis parallel/sp.py shards
GAE over), each device keeps its Q block resident, and the K/V blocks
rotate around the ring via ``ppermute`` — N steps, each overlapping a
neighbor exchange with a block-attention update, exactly the scaling-book
ring-attention recipe.  Per-device attention memory is O(T/N · T/N) and the
wire traffic per step is one K/V block.  Each ring block runs in XLA (a
flash ring block would need separate query/key episode ids and a
logsumexp output from the kernel; see ROADMAP).

Numerically this is the flash online-softmax recurrence applied blockwise:
every device folds each arriving K/V block into (acc, running max, running
denominator), so the result equals the single-device masked softmax up to
f32 reassociation (tested against models/attn._mha with the global mask).

Masking matches models/attn.causal_episode_mask GLOBALLY: query t attends
key s iff s <= t and both carry the same episode id, where episode ids are
global — each shard's exclusive done-cumsum plus the done-count of every
earlier shard (one all_gather of N scalars, the same trick sp.gae_sp uses
for its affine carry).

Product surface: ``PPOConfig(sp_size=N)`` trains attention trunks over a
(dp, sp) mesh end-to-end — algo/seqpar.py reshards rollouts time-major and
routes every parallel attention pass through :func:`ring_mha` /
:func:`ring_mha_ids` (the V(s') bootstrap decode folds its self-token into
the online-softmax carry, see ``self_kv``).
"""
from __future__ import annotations

import math
from typing import Tuple

import jax
import jax.numpy as jnp

NEG = -1e9


def global_episode_ids(reset_after: jax.Array, axis_name: str) -> jax.Array:
    """[T_local, ...] int32 GLOBAL episode ids for a time-sharded window.

    Local exclusive cumsum + the total done count of every earlier time
    shard (shards are contiguous time blocks in axis order).
    """
    d = reset_after.astype(jnp.int32)
    local = jnp.cumsum(d, axis=0) - d
    counts = jnp.sum(d, axis=0)                        # [...]
    all_counts = jax.lax.all_gather(counts, axis_name) # [N, ...]
    idx = jax.lax.axis_index(axis_name)
    n = jax.lax.axis_size(axis_name)
    before = (jax.lax.broadcasted_iota(jnp.int32, (n,) + counts.shape, 0)
              < idx)
    offset = jnp.sum(jnp.where(before, all_counts, 0), axis=0)
    return local + offset[None]


def ring_mha(
    q: jax.Array,             # [T_local, ..., H, hd]
    k: jax.Array,
    v: jax.Array,
    reset_after: jax.Array,   # [T_local, ...] bool, episode ended AT step t
    axis_name: str,
) -> jax.Array:
    """Global causal episode-masked attention over the sp-sharded window.

    Equal (to f32 reassociation) to ``attn._mha(q_full, k_full, v_full,
    attn.causal_episode_mask(done_full))`` restricted to this shard's
    queries.
    """
    ep = global_episode_ids(reset_after, axis_name)
    return ring_mha_ids(q, k, v, ep, ep, axis_name)


def ring_mha_ids(
    q: jax.Array,             # [T_local, ..., H, hd]
    k: jax.Array,
    v: jax.Array,
    q_ep: jax.Array,          # [T_local, ...] int32 GLOBAL episode id per query
    k_ep: jax.Array,          # [T_local, ...] int32 GLOBAL episode id per key
    axis_name: str,
    self_kv: Tuple[jax.Array, jax.Array] = None,
) -> jax.Array:
    """Ring attention with explicit episode ids (the general core).

    Query slot t (global position ``axis_index * T_local + t``) attends key
    slot s iff ``s_global <= t_global`` and ``k_ep[s] == q_ep[t]``.  With
    ``self_kv=(k_self, v_self)`` ([T_local, ..., H, hd]) each query
    ADDITIONALLY attends its own private token — the V(s') bootstrap decode
    (algo/recurrent.compute_values_rnn's decode_next taken cross-device):
    the self score seeds the online-softmax carry, so it joins the global
    softmax exactly.
    """
    T = q.shape[0]
    hd = q.shape[-1]
    scale = 1.0 / math.sqrt(hd)
    n = jax.lax.axis_size(axis_name)
    me = jax.lax.axis_index(axis_name)

    ep = k_ep
    qpos = me * T + jnp.arange(T)

    # fold batch dims into the einsum-free core: work on [T, ..., H, hd]
    def block_update(carry, blk):
        acc, m, l = carry
        k_b, v_b, ep_b, src = blk
        kpos = src * T + jnp.arange(T)
        s = jnp.einsum("t...hk,s...hk->ts...h", q, k_b) * scale
        causal = (kpos.reshape((1, T) + (1,) * (s.ndim - 3))
                  <= qpos.reshape((T, 1) + (1,) * (s.ndim - 3)))
        valid = jnp.logical_and(causal, ep_b[None] == q_ep[:, None])
        # broadcast the [Tq, Tk, ...] mask over heads
        s = jnp.where(valid[..., None], s, NEG)
        m2 = jnp.maximum(m, jnp.max(s, axis=1))        # [Tq, ..., H]
        p = jnp.where(valid[..., None], jnp.exp(s - m2[:, None]), 0.0)
        alpha = jnp.exp(m - m2)
        l2 = l * alpha + jnp.sum(p, axis=1)
        acc2 = (acc * alpha[..., None]
                + jnp.einsum("ts...h,s...hk->t...hk", p, v_b))
        return acc2, m2, l2

    # derive the initial statistics from q so they inherit its
    # device-varying type under shard_map (plain zeros would be
    # replicated-typed and fail the fori_loop carry typecheck)
    if self_kv is not None:
        # seed the carry with the query's private self-token: weight
        # exp(s_self - m0) = 1, so after the ring it participates in the
        # global softmax exactly
        k_self, v_self = self_kv
        m0 = jnp.sum(q * k_self, axis=-1) * scale      # [T, ..., H]
        l0 = jnp.ones_like(m0)
        acc0 = v_self + 0.0 * q
    else:
        acc0 = jnp.zeros_like(q)
        l0 = 0.0 * q[..., 0]          # [T, ..., H]
        m0 = l0 + NEG

    def ring_step(r, state):
        (acc, m, l), (k_b, v_b, ep_b, src) = state
        carry2 = block_update((acc, m, l), (k_b, v_b, ep_b, src))
        # pass the K/V block to the next device around the ring: device i
        # receives block src-1 next (blocks flow forward in ring order)
        perm = [(i, (i + 1) % n) for i in range(n)]
        k_b = jax.lax.ppermute(k_b, axis_name, perm)
        v_b = jax.lax.ppermute(v_b, axis_name, perm)
        ep_b = jax.lax.ppermute(ep_b, axis_name, perm)
        return carry2, (k_b, v_b, ep_b, (src - 1) % n)

    state = ((acc0, m0, l0), (k, v, ep, me))
    state = jax.lax.fori_loop(0, n, ring_step, state)
    (acc, m, l), _ = state
    l_safe = jnp.where(l == 0.0, 1.0, l)
    return acc / l_safe[..., None]
