"""Tensor parallelism for the MLP: Megatron-style column/row sharding.

The reference never needs TP (<=128-wide MLPs, single cuBLAS GEMM per layer,
src/mat_mul.cu:149) and SURVEY.md §2a marks it "not required for parity, but
design the mesh to allow a model axis later".  This module is that axis: for
wide-hidden configs (the HalfCheetah-class 2x256+ regime and beyond), the
MLP's hidden dimension shards over a ``tp`` mesh axis:

  * layer 0 is COLUMN-parallel: each rank holds W0[:, cols_r] and computes
    its slice of the first hidden layer; the activation is elementwise, so
    it applies on slices with no communication;
  * every later layer is ROW-parallel: rank r holds W_l[rows_r, :] (full
    output width) and contributes the partial product h_r @ W_l[rows_r, :];
    a psum over ``tp`` completes the contraction.  Middle layers then slice
    their own columns back out of the replicated activation to stay
    column-sharded for the next layer; the last layer stays replicated.

Comm cost: one psum of [B, width] per non-first layer, inside a
(dp, tp) mesh.  Under autodiff inside shard_map, psum transposes correctly,
so gradients arrive per-shard and per-device Adam slices update locally with
no extra collectives (tests/test_tp.py checks grads against the replicated
net exactly).

Param layout ("tp-local pytree", same structure as models/mlp.init):
  * W0 [d_in, H/tp], b0 [H/tp]           (column slice)
  * W_l [H/tp, width_l], b_l [width_l]   (row slice, replicated bias)
Single-layer nets have no hidden dim and stay fully replicated.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import jax
import jax.numpy as jnp

from ppoc_tpu.models.mlp import _ACTIVATIONS

Params = List[Tuple[jax.Array, jax.Array]]


def shard_params(params: Params, tp_rank: int, tp_size: int) -> Params:
    """Slice a full (replicated) MLP param pytree into rank ``tp_rank``'s
    tp-local shard.  Hidden sizes must divide tp_size."""
    n = len(params)
    if n == 1 or tp_size == 1:
        return [(w, b) for w, b in params]
    out: Params = []
    for i, (w, b) in enumerate(params):
        if i == 0:
            h = w.shape[1]
            assert h % tp_size == 0, f"hidden {h} % tp {tp_size} != 0"
            k = h // tp_size
            sl = slice(tp_rank * k, (tp_rank + 1) * k)
            out.append((w[:, sl], b[sl]))
        else:
            h = w.shape[0]
            assert h % tp_size == 0, f"hidden {h} % tp {tp_size} != 0"
            k = h // tp_size
            sl = slice(tp_rank * k, (tp_rank + 1) * k)
            out.append((w[sl, :], b))
    return out


def shard_params_all(params: Params, tp_size: int) -> List[Params]:
    """All tp shards (host-side helper for placing params on a mesh)."""
    return [shard_params(params, r, tp_size) for r in range(tp_size)]


def unshard_params(shards: List[Params]) -> Params:
    """Reassemble the full pytree from all tp shards (checkpointing)."""
    if len(shards) == 1:
        return shards[0]
    n = len(shards[0])
    if n == 1:
        return shards[0]
    out: Params = []
    for i in range(n):
        if i == 0:
            w = jnp.concatenate([s[i][0] for s in shards], axis=1)
            b = jnp.concatenate([s[i][1] for s in shards], axis=0)
        else:
            w = jnp.concatenate([s[i][0] for s in shards], axis=0)
            b = shards[0][i][1]
        out.append((w, b))
    return out


def pack_mlp(params: Params, tp_size: int, axis_name: str = "tp"):
    """(packed pytree, PartitionSpec pytree) for placing an MLP on a tp axis.

    Sharded leaves (all weights; the column layer's bias) are stacked along a
    new leading tp dim with spec P(axis_name); row-layer biases stay
    replicated with spec P().  ``unpack_mlp_local`` inverts this inside
    shard_map.  Gradients/Adam moments follow the identical layout: row-bias
    gradients are tp-invariant because the bias adds to an already-psum'd
    activation (tests/test_tp.py).
    """
    from jax.sharding import PartitionSpec as P

    shards = shard_params_all(params, tp_size)
    n = len(params)
    packed, specs = [], []
    for i in range(n):
        w = jnp.stack([s[i][0] for s in shards])
        if i == 0 and n > 1:
            b = jnp.stack([s[i][1] for s in shards])
            packed.append((w, b))
            specs.append((P(axis_name), P(axis_name)))
        elif n == 1:
            packed.append((w, jnp.stack([s[i][1] for s in shards])))
            specs.append((P(axis_name), P(axis_name)))
        else:
            packed.append((w, shards[0][i][1]))
            specs.append((P(axis_name), P()))
    return packed, specs


def unpack_mlp_local(packed: Params) -> Params:
    """Strip the leading tp dim inside shard_map (local shard view)."""
    n = len(packed)
    return [
        (w[0], b[0] if (i == 0 or n == 1) else b)
        for i, (w, b) in enumerate(packed)
    ]


def repack_mlp_local(params: Params) -> Params:
    """Re-add the leading tp dim to local leaves (inverse of unpack)."""
    n = len(params)
    return [
        (w[None], b[None] if (i == 0 or n == 1) else b)
        for i, (w, b) in enumerate(params)
    ]


def unshard_packed(packed: Params) -> Params:
    """Host-side: packed [tp, ...] leaves -> the full replicated pytree
    (checkpointing)."""
    n = len(packed)
    tp_size = packed[0][0].shape[0]
    shards = [
        [
            (w[r], b[r] if (i == 0 or n == 1) else b)
            for i, (w, b) in enumerate(packed)
        ]
        for r in range(tp_size)
    ]
    return unshard_params(shards)


def apply_tp(
    params: Params,
    x: jax.Array,
    activation: str = "relu",
    tp_axis: Optional[str] = None,
) -> jax.Array:
    """Forward pass on tp-local params inside shard_map over ``tp_axis``.

    Semantics match mlp.apply(full_params, x, activation, "jnp") exactly
    (tests/test_tp.py).  With tp_axis=None (tp_size 1) this degrades to the
    plain forward.
    """
    act = _ACTIVATIONS[activation]
    n = len(params)
    if tp_axis is None or n == 1:
        h = x
        for i, (w, b) in enumerate(params):
            h = h @ w + b
            if i < n - 1:
                h = act(h)
        return h

    rank = jax.lax.axis_index(tp_axis)
    h = act(x @ params[0][0] + params[0][1])          # column-parallel, local
    for i in range(1, n):
        w, b = params[i]
        z = jax.lax.psum(h @ w, tp_axis)              # row-parallel contraction
        if i == n - 1:
            return z + b                              # replicated output
        full = act(z + b)                             # replicated activation
        k = w.shape[1] // jax.lax.axis_size(tp_axis)  # re-slice own columns
        h = jax.lax.dynamic_slice_in_dim(full, rank * k, k, axis=full.ndim - 1)
    return h
