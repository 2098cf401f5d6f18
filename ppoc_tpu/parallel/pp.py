"""Pipeline parallelism for the MLP: layer partitioning + GPipe microbatches.

The reference needs no PP (a 2-hidden-layer MLP, SURVEY.md §2a "not
required"); this module provides the strategy natively in JAX for deeper
stacks: layers partition into S contiguous stages over a ``pp`` mesh axis,
microbatches stream through the S-stage pipeline with activations handed to
the next stage by ``jax.lax.ppermute``, and autodiff runs the
reverse schedule automatically (ppermute transposes to the inverse shift).

Training integration (PPOConfig(pp_size=N)): parameters live as
:class:`StageParams` — per-stage zero-padded layer stacks placed P("pp") on
a (dp, pp) mesh — consumed by ``models/mlp.apply`` through the
``"pp:<axis>[:M]"`` backend inside shard_map.  Gradients arrive per-stage
(stage-local Adam, no extra collectives: padded-lane gradients are
identically zero so padded moments stay zero), and checkpoints store the
UNSHARDED logical layers (``unshard_pp``), so pp/tp/single-device
checkpoints are interchangeable.

SPMD trick: every stage must execute the SAME program, so all layer weights
are zero-padded to a common [W, W] square (W = max layer width).  Zero
padding is exact, not approximate: padded input slots are 0, padded weight
rows/columns are 0, and relu/tanh fix 0, so padded lanes stay 0 through the
whole pipeline and padded-position gradients vanish (tests/test_pp.py checks
forward and gradients exactly against the plain MLP).

Schedule: classic GPipe fill-and-drain over T = M + S - 1 ticks; stage ``s``
works on microbatch ``t - s`` at tick ``t`` (bubble fraction (S-1)/T).  The
final stage scatters its results into an output buffer that a single psum
replicates at the end.
"""
from __future__ import annotations

from typing import List, Tuple

import jax
import jax.numpy as jnp

from ppoc_tpu.models.mlp import _ACTIVATIONS as _ACT
from ppoc_tpu.parallel.mesh import type_varying

Params = List[Tuple[jax.Array, jax.Array]]


def stage_layout(params: Params, pp_size: int) -> Tuple[int, List[int]]:
    """(padded width W, per-layer logical output widths). Requires pp_size
    to divide the layer count."""
    n = len(params)
    if n % pp_size:
        raise ValueError(f"{n} layers do not partition into {pp_size} stages")
    widths = [params[0][0].shape[0]] + [w.shape[1] for w, _ in params]
    return max(widths), widths


def shard_stage_params(params: Params, pp_size: int):
    """Pack per-stage zero-padded square layers.

    Returns [pp_size] list of (W_stack [L/S, W, W], b_stack [L/S, W],
    act_mask [L/S]) — act_mask is 1 where the (global) layer applies the
    hidden activation (every layer but the last).
    """
    import numpy as np

    wmax, _ = stage_layout(params, pp_size)
    n = len(params)
    per = n // pp_size
    stages = []
    for s in range(pp_size):
        ws, bs, acts = [], [], []
        for l in range(s * per, (s + 1) * per):
            w, b = params[l]
            wp = np.zeros((wmax, wmax), np.float32)
            wp[: w.shape[0], : w.shape[1]] = np.asarray(w)
            bp = np.zeros((wmax,), np.float32)
            bp[: b.shape[0]] = np.asarray(b)
            ws.append(wp)
            bs.append(bp)
            acts.append(1.0 if l < n - 1 else 0.0)
        stages.append((
            jnp.asarray(np.stack(ws)), jnp.asarray(np.stack(bs)),
            jnp.asarray(np.asarray(acts, np.float32)),
        ))
    return stages


def unshard_stage_grads(stage_grads, params: Params, pp_size: int) -> Params:
    """Slice per-stage padded (dW_stack, db_stack, _) back to logical shapes."""
    per = len(params) // pp_size
    out: Params = []
    for s, (dws, dbs, _) in enumerate(stage_grads):
        for i in range(per):
            w, b = params[s * per + i]
            out.append((dws[i][: w.shape[0], : w.shape[1]], dbs[i][: b.shape[0]]))
    return out


def apply_pipeline(
    stage_w: jax.Array,     # [L/S, W, W] this stage's padded layers
    stage_b: jax.Array,     # [L/S, W]
    act_mask: jax.Array,    # [L/S] 1.0 -> apply hidden activation
    x: jax.Array,           # [M * mb, d_in] full (replicated) input batch
    out_dim: int,
    n_microbatches: int,
    activation: str = "relu",
    axis_name: str = "pp",
) -> jax.Array:
    """Run the GPipe schedule inside shard_map over ``axis_name``.

    Returns the [M * mb, out_dim] outputs, replicated across stages.
    """
    act = _ACT[activation]
    S = jax.lax.axis_size(axis_name)
    stage = jax.lax.axis_index(axis_name)
    M = n_microbatches
    wmax = stage_w.shape[-1]
    total, d_in = x.shape
    if total % M:
        raise ValueError(f"batch {total} does not split into {M} microbatches")
    mb = total // M
    x_mb = jnp.pad(x, ((0, 0), (0, wmax - d_in))).reshape(M, mb, wmax)

    def stage_compute(h):
        def layer(h, wb):
            w, b, a = wb
            z = jnp.dot(h, w, preferred_element_type=jnp.float32) + b
            return jnp.where(a > 0, act(z), z), None

        h, _ = jax.lax.scan(layer, h, (stage_w, stage_b, act_mask))
        return h

    def tick(carry, t):
        h_in, out_buf = carry
        my_mb = t - stage
        valid = jnp.logical_and(my_mb >= 0, my_mb < M)
        idx = jnp.clip(my_mb, 0, M - 1)
        # stage 0 ingests its microbatch; later stages consume the handoff
        h0 = jnp.where(valid, x_mb[idx], jnp.zeros((mb, wmax), x.dtype))
        h = jnp.where(stage == 0, h0, h_in)
        h_out = stage_compute(h)
        # last stage banks its finished microbatch
        write = jnp.logical_and(valid, stage == S - 1)
        upd = jnp.where(write, h_out, out_buf[idx])
        out_buf = jax.lax.dynamic_update_index_in_dim(out_buf, upd, idx, 0)
        # hand activations to the next stage around the ring
        h_next = jax.lax.ppermute(
            h_out, axis_name, [(i, (i + 1) % S) for i in range(S)]
        )
        return (h_next, out_buf), None

    # initial carry must be typed device-varying over pp AND over any other
    # mesh axis the inputs vary over (e.g. dp when x is a per-device batch
    # on a (dp, pp) mesh) — the scan carry's type must match the stepped
    # carry, which inherits the inputs' varying axes.
    axes = {axis_name}
    for ref in (x, stage_w):
        try:
            axes |= set(jax.typeof(ref).vma)
        except AttributeError:
            pass
    axes = tuple(sorted(axes))
    h_init = type_varying(jnp.zeros((mb, wmax), x.dtype), axes)
    out_init = type_varying(jnp.zeros((M, mb, wmax), x.dtype), axes)
    (_, out_buf), _ = jax.lax.scan(
        tick, (h_init, out_init), jnp.arange(M + S - 1)
    )
    # only the last stage wrote; one psum replicates the result everywhere
    out_buf = jax.lax.psum(
        jnp.where(stage == S - 1, out_buf, jnp.zeros_like(out_buf)), axis_name
    )
    return out_buf.reshape(total, wmax)[:, :out_dim]


# --------------------------------------------------------------------------
# Training integration: StageParams pytree + pack/unpack/unshard
# --------------------------------------------------------------------------

@jax.tree_util.register_pytree_node_class
class StageParams:
    """Pipeline-stage view of an MLP's parameters.

    Array children: ``w`` (padded square layer stack), ``b``, ``act``
    (1.0 where the hidden activation applies).  Packed form (host / mesh
    placement) carries a leading [S] stage dim with spec P(pp_axis); the
    local form (inside shard_map) has it stripped.  Static aux: ``widths``
    — the logical layer-size list [d_in, h1, ..., out], from which the
    padded width, per-stage layer count and output dim all derive, so
    unsharding needs no external template.
    """

    def __init__(self, w, b, act, widths):
        self.w, self.b, self.act = w, b, act
        self.widths = tuple(widths)

    def tree_flatten(self):
        return (self.w, self.b, self.act), self.widths

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*children, aux)

    def __repr__(self):
        return f"StageParams(widths={self.widths}, w={getattr(self.w, 'shape', self.w)})"


def pack_pp(params: Params, pp_size: int, axis_name: str = "pp"):
    """(packed StageParams, PartitionSpec StageParams) for mesh placement."""
    from jax.sharding import PartitionSpec as P

    widths = [params[0][0].shape[0]] + [w.shape[1] for w, _ in params]
    stages = shard_stage_params(params, pp_size)
    packed = StageParams(
        jnp.stack([s[0] for s in stages]),
        jnp.stack([s[1] for s in stages]),
        jnp.stack([s[2] for s in stages]),
        widths,
    )
    spec = StageParams(P(axis_name), P(axis_name), P(axis_name), widths)
    return packed, spec


def unpack_pp_local(sp: StageParams) -> StageParams:
    """Strip the leading stage dim inside shard_map (local stage view)."""
    return StageParams(sp.w[0], sp.b[0], sp.act[0], sp.widths)


def repack_pp_local(sp: StageParams) -> StageParams:
    """Re-add the leading stage dim to local leaves (inverse of unpack)."""
    return StageParams(sp.w[None], sp.b[None], sp.act[None], sp.widths)


def unshard_pp(sp: StageParams) -> Params:
    """Host-side: packed [S, L/S, W, W] stacks -> logical [(W, b), ...]
    (checkpointing; inverse of pack_pp up to the zero padding)."""
    widths = sp.widths
    n = len(widths) - 1
    S = sp.w.shape[0]
    per = n // S
    out: Params = []
    for l in range(n):
        s, i = divmod(l, per)
        out.append((
            sp.w[s, i, : widths[l], : widths[l + 1]],
            sp.b[s, i, : widths[l + 1]],
        ))
    return out


def apply_pp(sp: StageParams, x: jax.Array, activation: str, spec: str) -> jax.Array:
    """mlp.apply entry point for the ``"pp:<axis>[:M]"`` backend: run the
    GPipe pipeline on the LOCAL stage params inside shard_map.

    ``spec`` is ``"<axis>"`` or ``"<axis>:<M>"`` (M = microbatches; default
    = the pp axis size).  Accepts any leading batch dims; their product must
    divide M.
    """
    parts = spec.split(":")
    axis_name = parts[0]
    S = jax.lax.axis_size(axis_name)
    M = int(parts[1]) if len(parts) > 1 and int(parts[1]) > 0 else S
    out_dim = sp.widths[-1]
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1])
    out = apply_pipeline(
        sp.w, sp.b, sp.act, x2, out_dim, M, activation, axis_name
    )
    return out.reshape(*lead, out_dim)
