"""Recurrent trunks: GRU or LSTM encoder + dense MLP head.

The framework's third model family (after the dense MLP, models/mlp.py, and
the mixture-of-experts trunk, models/moe.py).  The reference has no
recurrence — its policy/value nets are stateless MLPs over fully-observed
states (src/neural_network.cu, src/policy.cu) — but a complete PPO framework
needs memory for partially-observable tasks, so this extends the same trunk
slot (``policy_params["mlp"]`` / ``v_params``) with a structural kind that
rollouts and update phases dispatch on (algo/recurrent.py), exactly the way
MoE trunks do.

Program shape: the per-step cell is two fused wide GEMMs ([B, D] @
[D, G*H] with all gates computed jointly, G = 3 for GRU / 4 for LSTM, so
the matrix units see one contraction per input/hidden); sequence application is a
``lax.scan`` over time with episode-boundary masking, so a whole [T, E]
rollout window BPTTs as one compiled program.

Parameters (a dict so jax.tree utilities, the Adam optimizer, checkpointing
and shard_map specs all treat it like any other trunk):

  {"cell": {"wx": [in, G*H], "wh": [H, G*H], "b": [G*H]},
   "head": mlp.Params}                                # [H, *hidden, out]

The cell KIND is structural — G = wh.shape[1] // wh.shape[0] — so every
consumer (rollout, BPTT update, checkpoint, serving) dispatches on shapes
with no extra metadata.  GRU gate layout along the 3H axis is
(reset | update | candidate); LSTM layout along 4H is
(input | forget | candidate | output).

State convention: one flat carry array per lane.  For the GRU that is h
([.., H]); for the LSTM it is concat(h, c) ([.., 2H]) so masking at
episode boundaries, shard_map specs, and the serving protocol treat both
kinds identically (the head only ever reads the first H columns).
"""
from __future__ import annotations

from typing import Dict, Sequence, Tuple

import jax
import jax.numpy as jnp

from . import mlp

GRUParams = Dict[str, object]


def is_rnn(params) -> bool:
    """Structural test: does this trunk pytree hold a recurrent cell?"""
    return isinstance(params, dict) and "cell" in params


def init(key: jax.Array, obs_dim: int, rnn_hidden: int,
         head_sizes: Sequence[int], cell: str = "gru") -> GRUParams:
    """Recurrent cell on the observation + MLP head over the hidden state.

    ``head_sizes`` is the full head layer list, e.g. (H, 128, 128, act).
    ``cell`` is "gru" or "lstm".  Cell weights use the reference's uniform
    fan-based scheme (src/neural_network.cu:40-51) with gain 1 — recurrent
    nets need the conservative gain or the hidden state saturates.  The
    LSTM forget-gate bias is initialized +1 (the standard trick: remember
    by default so gradients flow through time from the first updates).
    """
    if cell not in ("gru", "lstm"):
        raise ValueError(f"cell must be 'gru' or 'lstm', got {cell!r}")
    k_wx, k_wh, k_b, k_head = jax.random.split(key, 4)
    h = rnn_hidden
    g = 3 if cell == "gru" else 4

    def unif(k, fan_in, fan_out, shape):
        std = jnp.sqrt(2.0 / (fan_in + fan_out))
        bound = jnp.sqrt(3.0) * std
        return jax.random.uniform(k, shape, jnp.float32, -bound, bound)

    b = jax.random.uniform(
        k_b, (g * h,), jnp.float32,
        -1.0 / jnp.sqrt(obs_dim), 1.0 / jnp.sqrt(obs_dim))
    if cell == "lstm":  # forget gate is the second H-slice
        b = b.at[h:2 * h].add(1.0)
    cell_p = {
        "wx": unif(k_wx, obs_dim, g * h, (obs_dim, g * h)),
        "wh": unif(k_wh, h, g * h, (h, g * h)),
        "b": b,
    }
    return {"cell": cell_p, "head": mlp.init(k_head, head_sizes)}


def hidden_size(params: GRUParams) -> int:
    return params["cell"]["wh"].shape[0]


def cell_kind(params: GRUParams) -> str:
    """"gru" (3H gates) or "lstm" (4H gates), read off the weight shapes."""
    wh = params["cell"]["wh"]
    return "lstm" if wh.shape[1] == 4 * wh.shape[0] else "gru"


def state_size(params: GRUParams) -> int:
    """Width of the flat per-lane carry: H for GRU, 2H (h ‖ c) for LSTM."""
    h = hidden_size(params)
    return 2 * h if cell_kind(params) == "lstm" else h


def initial_state(params: GRUParams, batch_shape: Tuple[int, ...]) -> jax.Array:
    return jnp.zeros((*batch_shape, state_size(params)), jnp.float32)


def cell_step(params: GRUParams, s: jax.Array, x: jax.Array) -> jax.Array:
    """One recurrent step: new flat state s' given state s and input x.

    GRU: s is h [.., H].  LSTM: s is concat(h, c) [.., 2H].
    """
    c = params["cell"]
    H = c["wh"].shape[0]
    if cell_kind(params) == "lstm":
        h, cs = s[..., :H], s[..., H:]
        gates = x @ c["wx"] + c["b"] + h @ c["wh"]
        i = jax.nn.sigmoid(gates[..., :H])
        f = jax.nn.sigmoid(gates[..., H:2 * H])
        g = jnp.tanh(gates[..., 2 * H:3 * H])
        o = jax.nn.sigmoid(gates[..., 3 * H:])
        c2 = f * cs + i * g
        h2 = o * jnp.tanh(c2)
        return jnp.concatenate([h2, c2], axis=-1)
    gx = x @ c["wx"] + c["b"]
    gh = s @ c["wh"]
    r = jax.nn.sigmoid(gx[..., :H] + gh[..., :H])
    z = jax.nn.sigmoid(gx[..., H:2 * H] + gh[..., H:2 * H])
    n = jnp.tanh(gx[..., 2 * H:] + r * gh[..., 2 * H:])
    return (1.0 - z) * n + z * s


def head_apply(params: GRUParams, s: jax.Array, activation: str) -> jax.Array:
    h = s[..., :hidden_size(params)]  # LSTM: drop the cell half
    return mlp.apply(params["head"], h, activation, "jnp")


def step(params: GRUParams, h: jax.Array, x: jax.Array,
         activation: str) -> Tuple[jax.Array, jax.Array]:
    """One trunk step: (new hidden, head output)."""
    h2 = cell_step(params, h, x)
    return h2, head_apply(params, h2, activation)


def apply_seq(
    params: GRUParams,
    xs: jax.Array,            # [T, ..., in]
    reset_after: jax.Array,   # [T, ...] bool: episode ended AT step t, so the
                              # hidden feeding step t+1 restarts from zero
    activation: str,
    h0: jax.Array = None,     # [..., H]; zeros when None (window start)
) -> jax.Array:
    """Head outputs [T, ..., out] for a whole window, BPTT through time.

    The recurrence is masked at episode boundaries: the auto-reset rollout
    (envs/core.vector_autoreset_step) starts a fresh episode in the same
    lane after a done flag, and a fresh episode must not see its
    predecessor's memory.
    """
    if h0 is None:
        # derive the zero state from the inputs so it inherits their
        # device-varying type under shard_map (a plain jnp.zeros would be
        # replicated and fail the scan's carry typecheck on a dp mesh)
        h0 = initial_state(params, xs.shape[1:-1]) + 0.0 * xs[0, ..., :1]

    def body(h, inp):
        x_t, done_t = inp
        h2 = cell_step(params, h, x_t)
        y = head_apply(params, h2, activation)
        keep = jnp.logical_not(done_t)[..., None].astype(h2.dtype)
        return h2 * keep, y

    _, ys = jax.lax.scan(body, h0, (xs, reset_after))
    return ys
