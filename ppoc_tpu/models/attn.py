"""Attention trunks: causal Transformer encoder + dense MLP head.

The framework's fourth model family (dense MLP — models/mlp.py, mixture of
experts — models/moe.py, recurrent GRU/LSTM — models/gru.py).  The reference
has no attention at all (SURVEY §2a: "no attention; 'sequence' dim =
trajectory time"), but a complete sequence-model story for
partially-observable tasks needs the standard alternative to recurrence:
a causal self-attention encoder over the rollout window.  It fills the same
trunk slot (``policy_params["mlp"]`` / ``v_params``) and flows through the
same sequence-minibatch PPO machinery as the recurrent family
(algo/recurrent.py) — consumers dispatch structurally via :func:`is_attn`.

Shape of the work: training-time application is fully PARALLEL over time —
unlike the GRU's O(T) ``lax.scan``, the whole [T, B] window is a handful of
batched GEMMs ([T*B, d] projections and [T, T] score contractions); only the
rollout is sequential (one decode step per env step, carried KV cache).
This is the architectural reason to prefer attention for long windows:
BPTT depth 1 instead of T.  The attention core itself is chosen per window
by :func:`attention_core`: XLA's materialized-mask path, or past
``FLASH_MIN_T`` steps on a GPU the flash kernel (ops/flash_attn.py).

Architecture (pre-LN blocks, learned positional embedding):

  tokens  h0 = obs @ We + be + pos[t]
  block:  h  = h + Wo·MHA(LN1(h));  h = h + FF(LN2(h))
  out     head(LNf(h))                # dense MLP head, models/mlp.py

Parameters (plain pytree of arrays — Adam, checkpointing and shard_map
specs treat it like any other trunk; all sizes are read off shapes, no
metadata):

  {"attn": {"embed": (We [in, d], be [d]),
            "pos": [T_max, d],
            "blocks": [{"wqkv": [d, 3, H, hd], "bqkv": [3, H, hd],
                        "wo": [d, d], "bo": [d],
                        "ln1": (g, b), "ln2": (g, b),
                        "ff1": (W [d, f], b [f]), "ff2": (W [f, d], b [d])},
                       ...],
            "lnf": (g, b)},
   "head": mlp.Params}                                 # [d, *hidden, out]

Masking convention (shared by the parallel trainer path and the sequential
rollout decode, so replayed log-probs match the stored ones): token t may
attend token s iff s <= t and both belong to the same episode, where
episodes are delimited by the ``reset_after`` flags — ``reset_after[t]``
true means the episode ended AT step t, so step t+1 starts fresh.  Positions
are window-absolute (pos[t] for window step t), identical in rollout and
replay.
"""
from __future__ import annotations

import math
from typing import Dict, List, Sequence, Tuple

import jax
import jax.numpy as jnp

from . import mlp

AttnParams = Dict[str, object]

NEG_INF = -1e9  # large-negative mask value: exp() underflows to exactly 0 in
                # f32, and (unlike -inf) keeps softmax gradients NaN-free

# Windows from which attention runs the flash kernel on a GPU
# (attention_core).  On an H100 the kernel's fwd+bwd beats XLA's path at
# every window measured, from 512 steps (0.51 vs 1.03 ms at 32 envs x 4
# heads x hd 8; 0.80 vs 1.11 ms at d 512) up to 4096, and XLA cannot run
# 8192 at all (bench_attn.py; PERF.md).  Shorter windows keep XLA's path.
FLASH_MIN_T = 512

# Which GEMM sites the "bf16" backend actually runs in bf16.  The full set
# is the production default; the bf16 long-context bisect (VERDICT r4 #5,
# examples/recall_bf16_bisect.py) removes one site at a time — promoting
# that site's operands back to f32 — to locate which tensor's rounding
# kills recall_long's cue gradient.  Sites: embed | qkv | scores (the Q.K
# logits) | av (the prob x V product) | out (attention output proj) |
# ff | head.
BF16_SITES = frozenset({"embed", "qkv", "scores", "av", "out", "ff",
                        "head"})


def is_attn(params) -> bool:
    """Structural test: does this trunk pytree hold an attention encoder?"""
    return isinstance(params, dict) and "attn" in params


def init(key: jax.Array, obs_dim: int, d: int, n_layers: int, n_heads: int,
         ff: int, t_max: int, head_sizes: Sequence[int]) -> AttnParams:
    """Causal Transformer encoder of width ``d`` + MLP head.

    ``head_sizes`` is the full head layer list, e.g. (d, 128, 128, act).
    Weights use the reference's uniform fan-based scheme
    (src/neural_network.cu:40-51) with gain 1 (residual streams need the
    conservative gain); LayerNorm gains start at 1, positional embeddings
    small-uniform.
    """
    if d % n_heads:
        raise ValueError(f"attn_dim ({d}) must be divisible by attn_heads "
                         f"({n_heads})")
    hd = d // n_heads
    keys = jax.random.split(key, 8 * n_layers + 4)

    def unif(k, fan_in, fan_out, shape):
        bound = math.sqrt(3.0) * math.sqrt(2.0 / (fan_in + fan_out))
        return jax.random.uniform(k, shape, jnp.float32, -bound, bound)

    def bias(k, fan_in, shape):
        b = 1.0 / math.sqrt(fan_in)
        return jax.random.uniform(k, shape, jnp.float32, -b, b)

    blocks: List[Dict[str, object]] = []
    for i in range(n_layers):
        k0, k1, k2, k3, k4, k5, k6, k7 = keys[8 * i : 8 * i + 8]
        blocks.append({
            "wqkv": unif(k0, d, d, (d, 3, n_heads, hd)),
            "bqkv": bias(k1, d, (3, n_heads, hd)),
            "wo": unif(k2, d, d, (d, d)),
            "bo": bias(k3, d, (d,)),
            "ln1": (jnp.ones((d,), jnp.float32), jnp.zeros((d,), jnp.float32)),
            "ln2": (jnp.ones((d,), jnp.float32), jnp.zeros((d,), jnp.float32)),
            "ff1": (unif(k4, d, ff, (d, ff)), bias(k5, d, (ff,))),
            "ff2": (unif(k6, ff, d, (ff, d)), bias(k7, ff, (d,))),
        })
    k_e, k_eb, k_p, k_h = keys[-4:]
    attn = {
        "embed": (unif(k_e, obs_dim, d, (obs_dim, d)),
                  bias(k_eb, obs_dim, (d,))),
        "pos": jax.random.uniform(k_p, (t_max, d), jnp.float32, -0.02, 0.02),
        "blocks": blocks,
        "lnf": (jnp.ones((d,), jnp.float32), jnp.zeros((d,), jnp.float32)),
    }
    return {"attn": attn, "head": mlp.init(k_h, head_sizes)}


def width(params: AttnParams) -> int:
    return params["attn"]["embed"][0].shape[1]


def window(params: AttnParams) -> int:
    """T_max: the longest context the positional table supports."""
    return params["attn"]["pos"].shape[0]


def _ln(x: jax.Array, gb) -> jax.Array:
    g, b = gb
    mu = jnp.mean(x, axis=-1, keepdims=True)
    var = jnp.mean(jnp.square(x - mu), axis=-1, keepdims=True)
    return (x - mu) * jax.lax.rsqrt(var + 1e-6) * g + b


def _dot(a: jax.Array, w: jax.Array, bf16: bool) -> jax.Array:
    """a @ w, optionally with bf16 operands and f32 accumulation (the
    mixed-precision recipe of mlp.apply's bf16 backend)."""
    if bf16:
        return jnp.dot(a.astype(jnp.bfloat16), w.astype(jnp.bfloat16),
                       preferred_element_type=jnp.float32)
    return a @ w


def _ff(x: jax.Array, blk, activation: str, bf16: bool = False) -> jax.Array:
    from .mlp import _ACTIVATIONS

    w1, b1 = blk["ff1"]
    w2, b2 = blk["ff2"]
    return _dot(_ACTIVATIONS[activation](_dot(x, w1, bf16) + b1),
                w2, bf16) + b2


def _embed(attn, x: jax.Array, bf16: bool = False) -> jax.Array:
    we, be = attn["embed"]
    return _dot(x, we, bf16) + be


def episode_ids(reset_after: jax.Array) -> jax.Array:
    """[T, ...] int32 episode index per step from the done flags (exclusive
    cumulative count: step t's episode ignores a done AT t — the final obs of
    an episode still belongs to it)."""
    d = reset_after.astype(jnp.int32)
    return jnp.cumsum(d, axis=0) - d


def causal_episode_mask(reset_after: jax.Array) -> jax.Array:
    """[T_q, T_k, ...] bool: query t may attend key s (s <= t, same episode)."""
    ep = episode_ids(reset_after)
    T = ep.shape[0]
    causal = (
        jax.lax.broadcasted_iota(jnp.int32, (T, T), 1)
        <= jax.lax.broadcasted_iota(jnp.int32, (T, T), 0)
    )
    same = ep[None, :] == ep[:, None]  # [Tq, Tk, ...]
    return jnp.logical_and(
        causal.reshape((T, T) + (1,) * (same.ndim - 2)), same)


def _mha(q: jax.Array, k: jax.Array, v: jax.Array,
         mask: jax.Array) -> jax.Array:
    """Masked multi-head attention on [T, ..., H, hd] tensors with a
    [T_q, T_k, ...] mask; returns [T_q, ..., H, hd]."""
    hd = q.shape[-1]
    # f32 scores/softmax regardless of the q/k dtype (bf16 inputs keep the
    # matmul cheap; the softmax statistics must not round to bf16)
    scores = jnp.einsum("t...hk,s...hk->ts...h", q, k,
                        preferred_element_type=jnp.float32) / math.sqrt(hd)
    scores = jnp.where(mask[..., None], scores, NEG_INF)
    w = jax.nn.softmax(scores, axis=1)
    return jnp.einsum("ts...h,s...hk->t...hk", w.astype(v.dtype), v,
                      preferred_element_type=jnp.float32)


def _platform() -> str:
    return jax.default_backend()


def uses_flash(T: int, backend: str) -> bool:
    """Does a T-step window's attention run the flash kernel?  Only on a
    GPU, from FLASH_MIN_T steps, and under "bf16" only while both attention
    products are bf16 sites (the kernel carries one operand dtype).  The
    CPU always runs XLA's path."""
    if _platform() != "gpu" or T < FLASH_MIN_T:
        return False
    return backend != "bf16" or {"scores", "av"} <= BF16_SITES


def attention_core(reset_after: jax.Array, backend: str = "jnp"):
    """The attention core for one window, ``(q, k, v) -> out`` on
    [T, ..., H, hd] tensors with causal episode masking from
    ``reset_after`` — the single place that picks between the flash kernel
    (:func:`uses_flash`) and XLA's path, which materializes the
    [T, T, ...] mask and score planes.  Under "bf16" the XLA path casts
    q/k (site "scores") and v (site "av") to bf16 separately, with f32
    softmax and accumulation either way."""
    T = reset_after.shape[0]
    bf16 = backend == "bf16"
    if uses_flash(T, backend):
        from ppoc_tpu.ops import flash_attn

        ep = episode_ids(reset_after)
        dt = jnp.bfloat16 if bf16 else None
        return lambda q, k, v: flash_attn.flash_mha(q, k, v, ep,
                                                    compute_dtype=dt)
    mask = causal_episode_mask(reset_after)
    bf16_sc = bf16 and "scores" in BF16_SITES
    bf16_av = bf16 and "av" in BF16_SITES

    def mha(q, k, v):
        if bf16_sc:
            q, k = q.astype(jnp.bfloat16), k.astype(jnp.bfloat16)
        if bf16_av:
            v = v.astype(jnp.bfloat16)
        return _mha(q, k, v, mask)

    return mha


def _qkv(blk, u: jax.Array,
         bf16: bool = False) -> Tuple[jax.Array, jax.Array, jax.Array]:
    w = blk["wqkv"]
    if bf16:
        u = u.astype(jnp.bfloat16)
        w = w.astype(jnp.bfloat16)
    qkv = jnp.einsum("...d,dchk->...chk", u, w,
                     preferred_element_type=jnp.float32) + blk["bqkv"]
    return qkv[..., 0, :, :], qkv[..., 1, :, :], qkv[..., 2, :, :]


def apply_seq(
    params: AttnParams,
    xs: jax.Array,            # [T, ..., in]
    reset_after: jax.Array,   # [T, ...] bool (see module docstring)
    activation: str,
    with_cache: bool = False,
    backend: str = "jnp",
    return_hidden: bool = False,
):
    """Head outputs [T, ..., out] for a whole window, all steps in parallel.

    ``with_cache=True`` additionally returns the per-layer key/value tensors
    (lists of [T, ..., H, hd]) for :func:`decode_next`.  The attention
    core comes from :func:`attention_core`.
    ``return_hidden=True`` returns ``(out, hidden)`` where ``hidden`` is the
    final-LN trunk plane the head reads ([T, ..., d]) — the auxiliary value
    head's input (cfg.aux_value_coeff; exclusive with with_cache).
    """
    attn = params["attn"]
    T = xs.shape[0]
    t_max = attn["pos"].shape[0]
    if T > t_max:
        raise ValueError(
            f"window length {T} exceeds the positional table ({t_max}); "
            f"init the trunk with t_max >= the rollout length")
    bf16 = backend == "bf16"
    site = (lambda s: bf16 and s in BF16_SITES)
    pos = attn["pos"][:T].reshape((T,) + (1,) * (xs.ndim - 2) + (-1,))
    h = _embed(attn, xs, site("embed")) + pos
    mha = attention_core(reset_after, backend)
    ks, vs = [], []
    for blk in attn["blocks"]:
        u = _ln(h, blk["ln1"])
        q, k, v = _qkv(blk, u, site("qkv"))
        if with_cache:
            ks.append(k)
            vs.append(v)
        o = mha(q, k, v)
        h = h + _dot(o.reshape(o.shape[:-2] + (-1,)), blk["wo"],
                     site("out")) + blk["bo"]
        h = h + _ff(_ln(h, blk["ln2"]), blk, activation, site("ff"))
    hn = _ln(h, attn["lnf"])
    out = mlp.apply(params["head"], hn, activation,
                    "bf16" if site("head") else "jnp")
    if with_cache:
        return out, ks, vs
    return (out, hn) if return_hidden else out


def apply_seq_sp(
    params: AttnParams,
    xs: jax.Array,            # [T_local, ..., in]: this device's TIME shard
    reset_after: jax.Array,   # [T_local, ...] bool
    activation: str,
    axis_name: str = "sp",
    with_cache: bool = False,
):
    """Sequence-parallel :func:`apply_seq`: the window is time-sharded over
    mesh axis ``axis_name`` and every attention core runs as ring attention
    (parallel/ring_attn.ring_mha_ids) — K/V blocks rotate between devices
    while LayerNorm/FF/head stay position-local.  Positions and episode ids
    are GLOBAL (shard offset = axis_index * T_local), so the result equals
    the unsharded apply_seq on the gathered window up to f32
    reassociation.

    ``with_cache=True`` returns ``(out, ks, vs, ep)``: the LOCAL per-layer
    K/V time blocks plus the global episode ids, the context
    :func:`decode_next_sp` rings around for the V(s') bootstrap.
    """
    from ppoc_tpu.parallel import ring_attn

    attn = params["attn"]
    T = xs.shape[0]
    n = jax.lax.axis_size(axis_name)
    t_max = attn["pos"].shape[0]
    if T * n > t_max:
        raise ValueError(
            f"global window {T} x {n} shards exceeds the positional table "
            f"({t_max}); init the trunk with t_max >= the rollout length")
    i = jax.lax.axis_index(axis_name)
    pos = jax.lax.dynamic_slice_in_dim(attn["pos"], i * T, T, 0)
    h = _embed(attn, xs) + pos.reshape((T,) + (1,) * (xs.ndim - 2) + (-1,))
    ep = ring_attn.global_episode_ids(reset_after, axis_name)
    ks, vs = [], []
    for blk in attn["blocks"]:
        u = _ln(h, blk["ln1"])
        q, k, v = _qkv(blk, u)
        if with_cache:
            ks.append(k)
            vs.append(v)
        o = ring_attn.ring_mha_ids(q, k, v, ep, ep, axis_name)
        h = h + _dot(o.reshape(o.shape[:-2] + (-1,)), blk["wo"], False) \
            + blk["bo"]
        h = h + _ff(_ln(h, blk["ln2"]), blk, activation)
    out = mlp.apply(params["head"], _ln(h, attn["lnf"]), activation, "jnp")
    return (out, ks, vs, ep) if with_cache else out


def decode_next_sp(
    params: AttnParams,
    x_next: jax.Array,        # [T_local, ..., in]: next-token per local slot
    ks: List[jax.Array],
    vs: List[jax.Array],
    ep: jax.Array,            # [T_local, ...] GLOBAL episode ids of the slots
    activation: str,
    axis_name: str = "sp",
) -> jax.Array:
    """Sequence-parallel :func:`decode_next`: next-token t attends the
    time-sharded context (global keys s <= t of the same episode, ringing
    over ``axis_name``) plus itself — the self token seeds the ring's
    online-softmax carry (``self_kv``), so the softmax is globally exact.
    Computes V(s'_t) for GAE in one pass per layer.
    """
    from ppoc_tpu.parallel import ring_attn

    attn = params["attn"]
    T = x_next.shape[0]
    t_max = attn["pos"].shape[0]
    i = jax.lax.axis_index(axis_name)
    pos_idx = jnp.minimum(i * T + jnp.arange(T) + 1, t_max - 1)
    h = _embed(attn, x_next) + attn["pos"][pos_idx].reshape(
        (T,) + (1,) * (x_next.ndim - 2) + (-1,))
    for blk, k_ctx, v_ctx in zip(attn["blocks"], ks, vs):
        u = _ln(h, blk["ln1"])
        q, k_self, v_self = _qkv(blk, u)
        o = ring_attn.ring_mha_ids(q, k_ctx, v_ctx, ep, ep, axis_name,
                                   self_kv=(k_self, v_self))
        h = h + o.reshape(o.shape[:-2] + (-1,)) @ blk["wo"] + blk["bo"]
        h = h + _ff(_ln(h, blk["ln2"]), blk, activation)
    return mlp.apply(params["head"], _ln(h, attn["lnf"]), activation, "jnp")


def decode_next(
    params: AttnParams,
    x_next: jax.Array,        # [T, ..., in]: one candidate "next token" per slot
    pos_idx: jax.Array,       # [T] int32 position index per next-token
    ks: List[jax.Array],
    vs: List[jax.Array],
    mask: jax.Array,          # [T_q, T_k, ...]: which CONTEXT keys each sees
    activation: str,
    backend: str = "jnp",
) -> jax.Array:
    """One-step decode for all T slots at once: next-token t attends the
    masked context (from :func:`apply_seq` ``with_cache=True``) plus itself.

    This computes V(s'_t) for the GAE bootstrap in ONE pass — the attention
    analogue of the GRU's one-extra-cell-step (algo/recurrent.py
    compute_values_rnn), vectorized over t.

    Long windows process the query axis in chunks (``lax.map``): the
    [T_q, T_k, ...] score planes would otherwise re-materialize in device
    memory the very footprint the flash kernel removes from apply_seq.
    """
    T = x_next.shape[0]
    if T > 2 * _DECODE_CHUNK:
        pad = -T % _DECODE_CHUNK
        xp = jnp.pad(x_next, ((0, pad),) + ((0, 0),) * (x_next.ndim - 1))
        pp = jnp.pad(pos_idx, (0, pad))
        mp = jnp.pad(mask, ((0, pad),) + ((0, 0),) * (mask.ndim - 1))
        n_chunks = xp.shape[0] // _DECODE_CHUNK

        def one(args):
            xc, pc, mc = args
            return _decode_next(params, xc, pc, ks, vs, mc, activation,
                                backend)

        out = jax.lax.map(one, (
            xp.reshape((n_chunks, _DECODE_CHUNK) + xp.shape[1:]),
            pp.reshape(n_chunks, _DECODE_CHUNK),
            mp.reshape((n_chunks, _DECODE_CHUNK) + mp.shape[1:]),
        ))
        return out.reshape((xp.shape[0],) + out.shape[2:])[:T]
    return _decode_next(params, x_next, pos_idx, ks, vs, mask, activation,
                        backend)


_DECODE_CHUNK = 128


def _decode_next(params, x_next, pos_idx, ks, vs, mask, activation,
                 backend="jnp"):
    bf16 = backend == "bf16"
    attn = params["attn"]
    h = _embed(attn, x_next, bf16) + attn["pos"][pos_idx].reshape(
        (x_next.shape[0],) + (1,) * (x_next.ndim - 2) + (-1,))
    hd = attn["blocks"][0]["wqkv"].shape[-1]
    scale = 1.0 / math.sqrt(hd)
    for blk, k_ctx, v_ctx in zip(attn["blocks"], ks, vs):
        u = _ln(h, blk["ln1"])
        q, k_self, v_self = _qkv(blk, u, bf16)
        s_ctx = jnp.einsum("t...hk,s...hk->ts...h", q, k_ctx) * scale
        s_ctx = jnp.where(mask[..., None], s_ctx, NEG_INF)
        s_self = jnp.sum(q * k_self, axis=-1, keepdims=False)[:, None] * scale
        w = jax.nn.softmax(jnp.concatenate([s_ctx, s_self], axis=1), axis=1)
        o = (jnp.einsum("ts...h,s...hk->t...hk", w[:, :-1], v_ctx)
             + w[:, -1][..., None] * v_self)
        h = h + _dot(o.reshape(o.shape[:-2] + (-1,)), blk["wo"], bf16) \
            + blk["bo"]
        h = h + _ff(_ln(h, blk["ln2"]), blk, activation, bf16)
    return mlp.apply(params["head"], _ln(h, attn["lnf"]), activation,
                     "bf16" if bf16 else "jnp")


# --------------------------------------------------------------------------
# sequential decode (rollout / serving)
# --------------------------------------------------------------------------

def initial_cache(params: AttnParams, batch_shape: Tuple[int, ...]) -> Dict:
    """Fresh KV cache for a window: per-layer keys/values [L, T_max, .., H, hd]
    plus per-lane episode-start pointers and the window step counter."""
    attn = params["attn"]
    n_layers = len(attn["blocks"])
    n_heads, hd = attn["blocks"][0]["wqkv"].shape[-2:]
    t_max = attn["pos"].shape[0]
    kv_shape = (n_layers, t_max, *batch_shape, n_heads, hd)
    return {
        "k": jnp.zeros(kv_shape, jnp.float32),
        "v": jnp.zeros(kv_shape, jnp.float32),
        "start": jnp.zeros(batch_shape, jnp.int32),
        "t": jnp.zeros((), jnp.int32),
    }


def step(params: AttnParams, cache: Dict, x: jax.Array,
         activation: str) -> Tuple[Dict, jax.Array]:
    """One decode step: (updated cache, head output [.., out]).

    The token is written into the cache and attends every cached position in
    [start_lane, t] — exactly the set :func:`apply_seq`'s mask grants, so a
    replay recomputes the same outputs.  Steps past the positional window
    clamp to the last slot (serving beyond the trained window degrades
    gracefully; training never hits this — the trainer sizes t_max to the
    rollout length).
    """
    attn = params["attn"]
    t_max = attn["pos"].shape[0]
    t = jnp.minimum(cache["t"], t_max - 1)
    h = _embed(attn, x) + attn["pos"][t]
    hd = attn["blocks"][0]["wqkv"].shape[-1]
    scale = 1.0 / math.sqrt(hd)
    # [T_max, ...] validity: cached position s visible iff start <= s <= t
    s_iota = jax.lax.broadcasted_iota(
        jnp.int32, (t_max,) + cache["start"].shape, 0)
    valid = jnp.logical_and(s_iota >= cache["start"][None], s_iota <= t)
    new_k, new_v = cache["k"], cache["v"]
    for i, blk in enumerate(attn["blocks"]):
        u = _ln(h, blk["ln1"])
        q, k_self, v_self = _qkv(blk, u)
        new_k = jax.lax.dynamic_update_index_in_dim(
            new_k, jax.lax.dynamic_update_index_in_dim(new_k[i], k_self, t, 0),
            i, 0)
        new_v = jax.lax.dynamic_update_index_in_dim(
            new_v, jax.lax.dynamic_update_index_in_dim(new_v[i], v_self, t, 0),
            i, 0)
        scores = jnp.einsum("s...hk,...hk->s...h", new_k[i], q) * scale
        scores = jnp.where(valid[..., None], scores, NEG_INF)
        w = jax.nn.softmax(scores, axis=0)
        o = jnp.einsum("s...h,s...hk->...hk", w, new_v[i])
        h = h + o.reshape(o.shape[:-2] + (-1,)) @ blk["wo"] + blk["bo"]
        h = h + _ff(_ln(h, blk["ln2"]), blk, activation)
    out = mlp.apply(params["head"], _ln(h, attn["lnf"]), activation, "jnp")
    cache = {"k": new_k, "v": new_v, "start": cache["start"],
             "t": cache["t"] + 1}
    return cache, out


def reset_lanes(cache: Dict, done: jax.Array) -> Dict:
    """Advance per-lane episode starts past the just-written token for lanes
    whose episode ended (the attention analogue of zeroing a GRU hidden).

    The start clamps to the final window slot like :func:`step`'s write
    position does: past the trained window an episode boundary must leave
    the lane attending its (clamped) current token, not an empty set —
    an unclamped start > t_max-1 would make every later softmax uniform
    over stale cross-episode cache entries.
    """
    t_max = cache["k"].shape[1]
    start = jnp.minimum(cache["t"], t_max - 1)
    return dict(cache, start=jnp.where(done, start, cache["start"]))
