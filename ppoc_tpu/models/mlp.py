"""Dense MLP: parameters, reference-exact initialization, forward pass.

Equivalent of the reference's ``NeuralNetwork`` (src/neural_network.cu:6-72,
include/neural_network.h:40-53), redesigned as a pure pytree of parameters
plus stateless apply functions:

  * init (src/neural_network.cu:40-51): per layer,
      gain  = sqrt(2) for hidden layers, 1 for the output layer
      std   = gain * sqrt(2 / (fan_in + fan_out))
      W    ~  U(-sqrt(3)*std, +sqrt(3)*std)          shape [fan_in, fan_out]
      b    ~  U(-1/sqrt(fan_in), +1/sqrt(fan_in))
  * forward (src/neural_network.cu:74-105 / :163-190): per layer
    ``x @ W + b`` then the activation; the last layer is linear.

The manual backward pass (src/neural_network.cu:121-231) is not re-coded
here: XLA differentiates the forward and fuses bias + activation into the
matmuls' epilogues.
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

import jax
import jax.numpy as jnp

Params = List[Tuple[jax.Array, jax.Array]]  # [(W, b), ...]

_ACTIVATIONS = {
    "relu": lambda x: jnp.maximum(x, 0.0),
    "tanh": jnp.tanh,
    "none": lambda x: x,
}


def init(key: jax.Array, sizes: Sequence[int]) -> Params:
    """Initialize weights with the reference scheme.

    ``sizes`` is the full layer-size list, e.g. [obs, 128, 128, act]
    (src/main.c:28).
    """
    params: Params = []
    n = len(sizes) - 1
    keys = jax.random.split(key, 2 * n)
    for i in range(n):
        fan_in, fan_out = sizes[i], sizes[i + 1]
        gain = 1.0 if i == n - 1 else jnp.sqrt(2.0)
        std = gain * jnp.sqrt(2.0 / (fan_in + fan_out))
        bound_w = jnp.sqrt(3.0) * std
        bound_b = 1.0 / jnp.sqrt(fan_in)
        w = jax.random.uniform(keys[2 * i], (fan_in, fan_out), jnp.float32, -bound_w, bound_w)
        b = jax.random.uniform(keys[2 * i + 1], (fan_out,), jnp.float32, -bound_b, bound_b)
        params.append((w, b))
    return params


def moe_backend(base: str, topk: int, ep_axis: str | None = None) -> str:
    """Encode MoE execution options as a backend string (parsed below)."""
    suffix = ":bf16" if base == "bf16" else ""
    if ep_axis is not None:
        return f"ep:{ep_axis}:{topk}{suffix}"
    return f"moe:{topk}{suffix}"


def _parse_moe_backend(backend: str):
    """-> (ep_axis, topk, bf16) for a MoE params tree under any backend."""
    parts = backend.split(":")
    if parts[0] == "ep":
        return parts[1], int(parts[2]), len(parts) > 3 and parts[3] == "bf16"
    if parts[0] == "moe":
        return None, int(parts[1]), len(parts) > 2 and parts[2] == "bf16"
    # generic backend string on a MoE tree: dense gating; bf16 if asked
    return None, 0, backend == "bf16"


def apply(params: Params, x: jax.Array, activation: str = "relu", backend: str = "jnp") -> jax.Array:
    """Forward pass on a batch ``x`` of shape [..., fan_in].

    Backends: "jnp" (XLA-fused), "bf16" (bfloat16 matmul operands,
    float32 accumulation), "tp:<axis>" (tensor-parallel forward on tp-local
    param shards inside shard_map, parallel/tp.py), "pp:<axis>[:M]"
    (GPipe pipeline forward on the local StageParams inside shard_map,
    parallel/pp.py), "moe:<topk>[:bf16]" (mixture-of-experts trunk,
    models/moe.py), or "ep:<axis>:<topk>[:bf16]" (expert-parallel MoE
    inside shard_map, parallel/ep.py).

    A mixture-of-experts params pytree (models/moe.is_moe) dispatches to
    moe.apply structurally, so generic callers passing "jnp"/"bf16" (e.g.
    serve.load_policy) work on MoE checkpoints — with dense (topk=0)
    gating unless the backend string carries the configured top-k.
    """
    from ppoc_tpu.models import moe

    if moe.is_moe(params):
        ep_axis, topk, bf16 = _parse_moe_backend(backend)
        return moe.apply(params, x, activation, ep_axis, topk, bf16)
    if backend.startswith("tp:"):
        from ppoc_tpu.parallel import tp

        return tp.apply_tp(params, x, activation, backend[3:])
    if backend.startswith("pp:"):
        from ppoc_tpu.parallel import pp

        return pp.apply_pp(params, x, activation, backend[3:])
    act = _ACTIVATIONS[activation]
    if backend == "bf16":
        # bf16 matmul operands with f32 accumulation and f32 master
        # weights: the mixed-precision recipe for the large-batch regime
        # (bf16 tensor-core rate, half the operand bytes).  Gradients flow
        # in f32 through the cast (its VJP is a cast back).
        h = x
        for i, (w, b) in enumerate(params):
            h = jnp.dot(h.astype(jnp.bfloat16), w.astype(jnp.bfloat16),
                        preferred_element_type=jnp.float32) + b
            if i < len(params) - 1:
                h = act(h)
        return h
    h = x
    for i, (w, b) in enumerate(params):
        h = h @ w + b
        if i < len(params) - 1:
            h = act(h)
    return h
