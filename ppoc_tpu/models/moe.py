"""Mixture-of-experts trunk: the framework's second model family.

The reference has exactly one model family — the dense MLP
(src/neural_network.cu) — and SURVEY.md §2a marks expert parallelism "not
required (no MoE)".  This module goes beyond that bar the same way
parallel/tp.py does for tensor parallelism: a gated mixture of complete
expert MLPs usable as the trunk of BOTH the policy mean-net and the value
net (``PPOConfig(n_experts=E)``), shardable over an ``ep`` mesh axis
(``PPOConfig(ep_size=N)``, parallel/ep.py + algo/trainer.py).

Architecture (per forward):

    gate    g = softmax(x @ Wr + br)               [..., E]
    experts h_e = MLP_e(x)                         [..., E, out]
    output  y = sum_e g_e * h_e                    [..., out]

with optional top-k gating (``moe_topk``): keep the k largest gate weights
per input, renormalize, zero the rest.  Compute is DENSE on purpose: at PPO
scale the experts are tiny MLPs, so evaluating all of them as one stacked
batched matmul (einsum over the expert dim — one dense contraction
with static shapes) is faster than the sorted scatter/gather dispatch used
at transformer scale, and no token is ever dropped (no capacity factor).
Expert parallelism still saves real compute: under ``ep`` sharding each
device evaluates only its n_experts/ep local experts on the (replicated)
batch and one psum over ``ep`` combines the weighted outputs — the same
all-to-all-free "dense EP" layout the gather-based variants reduce to when
capacity is unbounded.

Parameter layout ("stacked" pytree — the leading expert dim IS the ep
sharding dim, so no pack/repack step is needed, unlike TP):

    {"router":  (Wr [d_in, E], br [E]),             replicated over ep
     "experts": [(W0 [E, d_in, h], b0 [E, h]),
                 (W1 [E, h, h],    b1 [E, h]), ...]  P("ep") on dim 0}

Each expert is initialized with the reference's exact init scheme
(src/neural_network.cu:40-51) from its own PRNG key; the router is a
reference-init linear layer (gain 1).
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp

MoEParams = Dict[str, object]


def is_moe(params) -> bool:
    """Structural test: does this trunk pytree hold a mixture of experts?"""
    return isinstance(params, dict) and "experts" in params


def aux_setup(cfg, params, backend: str) -> Tuple[float, int]:
    """-> (load-balance aux coefficient, router top-k) for one update phase.

    (0.0, 0) for non-MoE trunks or moe_aux_coeff=0; otherwise the top-k is
    decoded from the backend string so the aux loss sees the same gating the
    forward pass uses.  Shared by the value and policy phases (algo/ppo.py)
    so the gating condition can never drift between them.
    """
    from ppoc_tpu.models import mlp

    coeff = cfg.moe_aux_coeff if is_moe(params) else 0.0
    topk = mlp._parse_moe_backend(backend)[1] if coeff else 0
    return coeff, topk


def init(key: jax.Array, sizes: Sequence[int], n_experts: int) -> MoEParams:
    """Router + ``n_experts`` stacked expert MLPs over the layer-size list
    ``sizes`` (e.g. [obs, 128, 128, act])."""
    from ppoc_tpu.models import mlp

    k_router, k_exp = jax.random.split(key)
    d_in = sizes[0]
    # router: reference init for a single linear layer (gain 1)
    std = jnp.sqrt(2.0 / (d_in + n_experts))
    bound_w = jnp.sqrt(3.0) * std
    bound_b = 1.0 / jnp.sqrt(d_in)
    kw, kb = jax.random.split(k_router)
    router = (
        jax.random.uniform(kw, (d_in, n_experts), jnp.float32, -bound_w, bound_w),
        jax.random.uniform(kb, (n_experts,), jnp.float32, -bound_b, bound_b),
    )
    expert_list = [mlp.init(k, sizes) for k in jax.random.split(k_exp, n_experts)]
    n_layers = len(expert_list[0])
    experts: List[Tuple[jax.Array, jax.Array]] = [
        (
            jnp.stack([e[l][0] for e in expert_list]),
            jnp.stack([e[l][1] for e in expert_list]),
        )
        for l in range(n_layers)
    ]
    return {"router": router, "experts": experts}


def n_experts(params: MoEParams) -> int:
    return params["experts"][0][0].shape[0]


def gate_weights(params: MoEParams, x: jax.Array, topk: int = 0) -> jax.Array:
    """Softmax gate over experts, optionally top-k masked + renormalized.
    Returns [..., E]."""
    wr, br = params["router"]
    g = jax.nn.softmax(x @ wr + br, axis=-1)
    e = g.shape[-1]
    if 0 < topk < e:
        _, idx = jax.lax.top_k(g, topk)
        mask = jnp.sum(jax.nn.one_hot(idx, e, dtype=g.dtype), axis=-2)
        g = g * mask
        g = g / jnp.maximum(jnp.sum(g, axis=-1, keepdims=True), 1e-9)
    return g


def load_balance_loss(params: MoEParams, x: jax.Array, topk: int = 0) -> jax.Array:
    """Switch-style load-balancing auxiliary loss: E * sum_e f_e * P_e.

    ``f_e`` is the fraction of inputs routed to expert e (their top-k set;
    argmax for dense gating) and ``P_e`` the mean softmax router
    probability.  Equals 1.0 under perfect balance, grows as the router
    collapses onto few experts; gradients flow through ``P_e`` only (the
    routing fractions are counts).  Weighted into the value/policy losses
    by ``PPOConfig.moe_aux_coeff`` (algo/ppo.py) — relevant mainly for
    top-k gating, where an unregularized router can starve experts; the
    dense softmax mixture degrades gracefully without it.
    """
    wr, br = params["router"]
    p = jax.nn.softmax(x @ wr + br, axis=-1)
    e = p.shape[-1]
    k = topk if 0 < topk < e else 1
    _, idx = jax.lax.top_k(p, k)
    sel = jnp.sum(jax.nn.one_hot(idx, e, dtype=p.dtype), axis=-2)
    f = jnp.mean(sel.reshape(-1, e), axis=0) / k
    mean_p = jnp.mean(p.reshape(-1, e), axis=0)
    return e * jnp.sum(jax.lax.stop_gradient(f) * mean_p)


def _expert_forward(
    experts: List[Tuple[jax.Array, jax.Array]],
    x: jax.Array,
    activation: str,
    bf16: bool,
) -> jax.Array:
    """All (local) experts on the full batch: [..., d_in] -> [..., E, out]."""
    from ppoc_tpu.models.mlp import _ACTIVATIONS

    act = _ACTIVATIONS[activation]

    def dot(a, b, spec):
        if bf16:
            return jnp.einsum(spec, a.astype(jnp.bfloat16), b.astype(jnp.bfloat16),
                              preferred_element_type=jnp.float32)
        return jnp.einsum(spec, a, b)

    w0, b0 = experts[0]
    h = dot(x, w0, "...i,eio->...eo") + b0
    for l in range(1, len(experts)):
        h = act(h)
        w, b = experts[l]
        h = dot(h, w, "...eo,eoh->...eh") + b
    return h


def apply(
    params: MoEParams,
    x: jax.Array,
    activation: str = "relu",
    ep_axis: Optional[str] = None,
    topk: int = 0,
    bf16: bool = False,
) -> jax.Array:
    """Mixture forward on a batch ``x`` [..., d_in] -> [..., out].

    With ``ep_axis`` (inside shard_map over that axis): ``params["experts"]``
    leaves are the LOCAL expert shard [E/ep, ...]; the (replicated) router
    computes the full global gate, each rank contracts its own gate slice
    with its local experts, and one psum over ``ep_axis`` completes the
    mixture.  Router gradients need no extra collective: each rank's
    backward covers only its gate slice, and shard_map's transpose of the
    invariant->varying conversion (pvary) psums the partial cotangents over
    ``ep_axis`` automatically, so every rank's Adam step sees the full
    router gradient and the replicated router stays bit-identical across
    ranks (verified against the single-device mixture in tests/test_ep.py).
    """
    if ep_axis is None:
        g = gate_weights(params, x, topk)
        h = _expert_forward(params["experts"], x, activation, bf16)
        return jnp.einsum("...e,...eo->...o", g, h)

    g = gate_weights(params, x, topk)  # full [.., E_global], replicated
    e_local = params["experts"][0][0].shape[0]
    rank = jax.lax.axis_index(ep_axis)
    g_local = jax.lax.dynamic_slice_in_dim(
        g, rank * e_local, e_local, axis=g.ndim - 1
    )
    h = _expert_forward(params["experts"], x, activation, bf16)
    partial = jnp.einsum("...e,...eo->...o", g_local, h)
    return jax.lax.psum(partial, ep_axis)
