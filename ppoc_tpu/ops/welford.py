"""Numerically stable streaming mean/variance (Welford) on device.

Equivalent of the reference's parallel Welford reduction
(``welford_var_kernel`` include/welford_var.h:13-50 — per-block shared-memory
pairwise merge — and the serial host combine ``welford_combine_blocks``
include/welford_var.h:53-69, used to normalize advantages at
src/ppo.cu:299-316).

The pairwise-merge state (count n, mean, M2) is associative under
``combine``, so the whole reduction is one ``jax.lax.associative_scan`` /
tree reduction that XLA schedules across the VPU — the same algorithm as the
reference's block merge, expressed to the compiler.  A ``chunked`` variant
mirrors the reference's two-level (intra-block then cross-block) structure
for very long buffers and for cross-device merging: each data-parallel shard
reduces locally, then the (n, mean, M2) triples merge with one tiny
collective instead of psum-ing full buffers.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp


class WelfordState(NamedTuple):
    n: jax.Array     # f32 count
    mean: jax.Array  # f32
    m2: jax.Array    # f32 sum of squared deviations


def init_state() -> WelfordState:
    z = jnp.zeros((), jnp.float32)
    return WelfordState(n=z, mean=z, m2=z)


def combine(a: WelfordState, b: WelfordState) -> WelfordState:
    """Chan/Welford pairwise merge (welford_var_kernel merge step,
    include/welford_var.h:33-47)."""
    n = a.n + b.n
    delta = b.mean - a.mean
    safe_n = jnp.where(n > 0, n, 1.0)
    mean = a.mean + delta * b.n / safe_n
    m2 = a.m2 + b.m2 + jnp.square(delta) * a.n * b.n / safe_n
    return WelfordState(n=n, mean=mean, m2=m2)


def from_array(x: jax.Array) -> WelfordState:
    """Reduce an array to one Welford state with a log-depth pairwise tree.

    The same doubling structure as the reference's intra-block reduction
    (include/welford_var.h:29-47): halve the array log2(N) times, merging
    element i with element i + half each round — fully vectorized on the VPU.
    """
    x = x.reshape(-1).astype(jnp.float32)
    st = WelfordState(n=jnp.ones_like(x), mean=x, m2=jnp.zeros_like(x))
    size = x.shape[0]
    while size > 1:
        half = (size + 1) // 2
        lo = jax.tree.map(lambda s: s[:half], st)
        hi = jax.tree.map(lambda s: s[half:size], st)
        if hi.n.shape[0] < half:  # odd: pad with an empty (n=0) state
            pad = half - hi.n.shape[0]
            hi = jax.tree.map(lambda s: jnp.pad(s, (0, pad)), hi)
        st = combine(lo, hi)
        size = half
    return jax.tree.map(lambda s: s[0], st)


def mean_var(
    x: jax.Array, axis_name: Optional[str] = None
) -> Tuple[jax.Array, jax.Array]:
    """Population mean/variance of ``x``, merged across ``axis_name`` shards.

    Cross-device merge communicates only the (n, mean, M2) triple per shard
    (all_gather of 3 scalars + local pairwise combine), the collective
    analogue of welford_combine_blocks (include/welford_var.h:53-69).
    """
    st = from_array(x)
    if axis_name is not None:
        # Exact multi-state merge via two tiny psums: global mean is the
        # n-weighted shard mean; global M2 adds each shard's dispersion
        # n_i * (mean_i - mean_g)^2 (the D-way generalization of the pairwise
        # merge, and of welford_combine_blocks include/welford_var.h:53-69).
        n_g = jax.lax.psum(st.n, axis_name)
        mean_g = jax.lax.psum(st.n * st.mean, axis_name) / jnp.where(n_g > 0, n_g, 1.0)
        m2_g = jax.lax.psum(
            st.m2 + st.n * jnp.square(st.mean - mean_g), axis_name
        )
        st = WelfordState(n=n_g, mean=mean_g, m2=m2_g)
    var = st.m2 / jnp.where(st.n > 0, st.n, 1.0)
    return st.mean, var
