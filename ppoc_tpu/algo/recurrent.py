"""Recurrent PPO: GRU-trunk rollouts and sequence-minibatch update phases.

The reference's nets are stateless MLPs over fully-observed states
(src/neural_network.cu, src/policy.cu), so its buffer can shuffle
TRANSITIONS freely (src/trajectory_buffer.cu:126-166).  A recurrent policy
breaks that: log-probs and values depend on episode history, so the update
must replay whole sequences.  This module keeps every reference semantic
that still applies — force-truncated windows, whole-buffer advantage
normalization, tail-dropped shuffled minibatches, three separate Adams
(src/ppo.cu:19-25, :355-368, :475-477) — but minibatches are ENV SEQUENCES
(columns of the [T, E] window) and log-probs/values are recomputed by
scanning the GRU over time with episode-boundary masking (models/gru.py),
i.e. truncated BPTT over the rollout window.

Program shape: everything is `lax.scan` over time inside `lax.scan` over
minibatches — one jitted program per fit, like the feedforward path
(algo/ppo.py).  Data parallelism composes unchanged: sequences shard over
the dp axis with the per-minibatch gradient pmean and the Welford
normalization psum as the only collectives.

Hidden-state convention (shared by rollout and update, so recomputed
log-probs match the stored ones bit-for-bit): the hidden feeding step t is
h_t; the cell consumes (h_t, obs_t) producing h_{t+1} and the step's head
output; h_{t+1} is zeroed where step t ended its episode (auto-reset lanes
start fresh).  Windows always start from h_0 = 0 — the trainer requires
``reset_per_fit=True`` for recurrent configs, so the window start IS an
episode start in every lane.
"""
from __future__ import annotations

import functools
import math
from typing import Any, Dict, Optional, Tuple

import jax
import jax.numpy as jnp

from ppoc_tpu.config import PPOConfig
from ppoc_tpu.data import buffer
from ppoc_tpu.envs.core import Env, vector_autoreset_step, vector_reset
from ppoc_tpu.models import attn, gru, mlp, policy as policy_mod
from ppoc_tpu.ops import adam, losses

LOG_2PI = math.log(2.0 * math.pi)


def _seq_apply(trunk, xs, reset_after, activation, backend: str = "jnp",
               sp_axis: Optional[str] = None):
    """Whole-window head outputs for either sequence family: the GRU/LSTM
    masked time scan or the attention causal-episode-masked parallel pass.
    Single dispatch point for the update phases, so both families share the
    sequence-minibatch PPO machinery below.  ``backend`` ("jnp"/"bf16")
    reaches attention trunks (GRU ignores it); ``sp_axis`` (attention only)
    runs the window time-sharded over that mesh axis via ring attention
    (models/attn.apply_seq_sp)."""
    if attn.is_attn(trunk):
        if sp_axis is not None:
            return attn.apply_seq_sp(trunk, xs, reset_after, activation,
                                     sp_axis)
        return attn.apply_seq(trunk, xs, reset_after, activation,
                              backend=backend)
    return gru.apply_seq(trunk, xs, reset_after, activation)


def seq_minibatch_plan(n_envs_local: int, rollout_len: int,
                       mb_size_local: int) -> Tuple[int, int]:
    """-> (sequences per minibatch, minibatches per epoch).

    ``minibatch_size`` counts TRANSITIONS everywhere else; a recurrent
    minibatch is whole env-sequences, so the closest plan with the same
    data volume is floor(mb_size / rollout_len) sequences (>= 1), with the
    tail of the env axis dropped like the reference's row tail
    (src/ppo.cu:475-477).
    """
    seqs = max(1, min(n_envs_local, mb_size_local // rollout_len))
    return seqs, n_envs_local // seqs


def _gather_seqs(arrs, idx: jax.Array):
    """Gather env columns (axis 1) of [T, E, ...] planes."""
    return jax.tree.map(lambda a: jnp.take(a, idx, axis=1), arrs)


# --------------------------------------------------------------------------
# rollout
# --------------------------------------------------------------------------

def rollout_rnn(
    cfg: PPOConfig,
    env: Env,
    policy_params: Dict[str, Any],
    key: jax.Array,
    n_envs: int,
    length: int,
    axis_name: Optional[str] = None,
    force_truncate: bool = True,
    deterministic: bool = False,
):
    """Collect [length, n_envs] transitions with a sequence-trunk policy.

    Mirrors ppo.rollout (collect_trajectories, src/ppo.cu:54-79) with the
    trunk's sequence state threaded through the scan — the GRU/LSTM hidden
    (zeroed in lanes whose episode ended, the recurrent analogue of the
    auto-reset) or the attention KV cache (episode-start pointers advanced
    past finished episodes).  Returns (Transition, final (env_state, obs,
    state) carry).
    """
    from ppoc_tpu.algo import ppo as ppo_mod

    k_reset, k_scan = jax.random.split(key)
    env_state, obs = ppo_mod._pvary(
        vector_reset(env, k_reset, n_envs), axis_name)
    s0 = initial_seq_state(cfg, policy_params, n_envs)
    if axis_name is not None:
        s0 = ppo_mod._pvary(s0, axis_name)
    step_fn = rollout_step_fn(cfg, env, policy_params, deterministic)
    keys = jax.random.split(k_scan, length)
    final_carry, traj = jax.lax.scan(step_fn, (env_state, obs, s0), keys)
    if force_truncate:
        traj = force_truncate_traj(traj)
    return traj, final_carry


def initial_seq_state(cfg: PPOConfig, policy_params, n_envs: int):
    """Fresh trunk sequence state for a rollout window: the attention KV
    cache or the GRU/LSTM zero hidden."""
    trunk = policy_params["mlp"]
    if attn.is_attn(trunk):
        return attn.initial_cache(trunk, (n_envs,))
    return gru.initial_state(trunk, (n_envs,))


def rollout_step_fn(cfg: PPOConfig, env: Env, policy_params,
                    deterministic: bool = False):
    """The per-step scan body of :func:`rollout_rnn`, exposed so the
    chunked-decode dispatch (cfg.rollout_chunk — one compiled SEGMENT
    program reused across a window's segments, the T=16384 relief valve)
    can scan the identical body over key slices."""
    from ppoc_tpu.algo import ppo as ppo_mod

    trunk = policy_params["mlp"]
    discrete = env.spec.discrete
    if attn.is_attn(trunk):
        trunk_step = functools.partial(attn.step, trunk,
                                       activation=cfg.activation)
        on_done = attn.reset_lanes
    else:
        def trunk_step(h, x):
            return gru.step(trunk, h, x, cfg.activation)

        def on_done(h, done):
            return h * jnp.logical_not(done)[..., None].astype(h.dtype)

    def step_fn(carry, key_t):
        env_state, obs, s = carry
        k_act, k_env = jax.random.split(key_t)
        s2, out = trunk_step(s, obs)
        action, logp = policy_mod.act_from_out(
            out, k_act, discrete, policy_params.get("log_std"),
            deterministic)
        env_state2, obs2, next_obs, reward, term, trunc = \
            vector_autoreset_step(env, env_state, action, k_env)
        done = jnp.logical_or(term, trunc)
        s_next = on_done(s2, done)
        tr = ppo_mod.Transition(obs, action, logp, next_obs, reward, term, trunc)
        return (env_state2, obs2, s_next), tr

    return step_fn


def force_truncate_traj(traj):
    """Mark the window's final row truncated unless terminated
    (src/ppo.cu:70-74) — GAE must never bootstrap across the window end."""
    last_trunc = jnp.logical_or(
        traj.truncated[-1], jnp.logical_not(traj.terminated[-1])
    )
    return traj._replace(truncated=traj.truncated.at[-1].set(last_trunc))


# --------------------------------------------------------------------------
# values / log-probs over stored windows
# --------------------------------------------------------------------------

def compute_values_rnn(
    cfg: PPOConfig, v_params, traj, backend: str = "jnp"
) -> Tuple[jax.Array, jax.Array]:
    """(V(s_t), V(s'_t)) planes [T, E] for GAE with a sequence value net.

    Replaces the two whole-buffer MLP forwards (src/ppo.cu:267-274).
    GRU/LSTM: one time scan — V(s'_t) is evaluated under the hidden state
    reached AFTER s_t, the history the critic would actually have at t+1.
    Attention: one parallel pass with the KV planes cached, then a
    one-step decode for all T next-tokens at once (models/attn.decode_next)
    — V(s'_t) attends (obs_<=t of the same episode, next_obs_t).
    """
    done = jnp.logical_or(traj.terminated, traj.truncated)
    if attn.is_attn(v_params):
        values, ks, vs = attn.apply_seq(
            v_params, traj.obs, done, cfg.activation, with_cache=True,
            backend=backend)
        T = traj.obs.shape[0]
        pos_idx = jnp.minimum(jnp.arange(T) + 1, attn.window(v_params) - 1)
        mask = attn.causal_episode_mask(done)
        nv = attn.decode_next(v_params, traj.next_obs, pos_idx, ks, vs,
                              mask, cfg.activation, backend=backend)
        return values[..., 0], nv[..., 0]
    # zero state derived from the (possibly device-varying) observations —
    # see gru.apply_seq
    h0 = (gru.initial_state(v_params, traj.obs.shape[1:-1])
          + 0.0 * traj.obs[0, ..., :1])

    def body(h, inp):
        obs_t, next_obs_t, done_t = inp
        h2 = gru.cell_step(v_params, h, obs_t)
        v_t = gru.head_apply(v_params, h2, cfg.activation)[..., 0]
        h_next = gru.cell_step(v_params, h2, next_obs_t)
        nv_t = gru.head_apply(v_params, h_next, cfg.activation)[..., 0]
        keep = jnp.logical_not(done_t)[..., None].astype(h2.dtype)
        return h2 * keep, (v_t, nv_t)

    _, (values, next_values) = jax.lax.scan(
        body, h0, (traj.obs, traj.next_obs, done))
    return values, next_values


def compute_values_sp(cfg: PPOConfig, v_params, traj,
                      sp_axis: str) -> Tuple[jax.Array, jax.Array]:
    """(V(s_t), V(s'_t)) [T_local, E] planes for a TIME-sharded window.

    The sequence-parallel form of :func:`compute_values_rnn`'s attention
    branch: the parallel pass runs as ring attention with the local K/V
    blocks kept (models/attn.apply_seq_sp with_cache), then the next-token
    decode rings the same context past every shard's V(s') queries
    (models/attn.decode_next_sp).
    """
    done = jnp.logical_or(traj.terminated, traj.truncated)
    values, ks, vs, ep = attn.apply_seq_sp(
        v_params, traj.obs, done, cfg.activation, sp_axis, with_cache=True)
    nv = attn.decode_next_sp(v_params, traj.next_obs, ks, vs, ep,
                             cfg.activation, sp_axis)
    return values[..., 0], nv[..., 0]


def _plan_T(rollout_len_local: int, sp_axis: Optional[str]) -> int:
    """GLOBAL window length for the minibatch plan: a local [T_local, E]
    column under sp is one T_local*sp_size-step sequence's shard, and
    ``minibatch_size`` counts GLOBAL transitions per sequence."""
    if sp_axis is None:
        return rollout_len_local
    return rollout_len_local * jax.lax.axis_size(sp_axis)


def policy_log_probs_rnn(cfg: PPOConfig, policy_params, obs, action, done,
                         discrete: bool,
                         backend: str = "jnp",
                         sp_axis: Optional[str] = None,
                         return_hidden: bool = False,
                         ):
    """(log-probs [T, B], mean entropy) of stored actions under the current
    recurrent policy, replayed from h0=0 with episode-boundary masking —
    identical recurrence to rollout_rnn, so at epoch 0 the ratios are
    exactly 1.  ``return_hidden=True`` (attention trunks, no sp) appends
    the trunk's final-LN hidden plane — the auxiliary value head's input
    (cfg.aux_value_coeff)."""
    if return_hidden:
        out, hidden = attn.apply_seq(policy_params["mlp"], obs, done,
                                     cfg.activation, backend=backend,
                                     return_hidden=True)
    else:
        out = _seq_apply(policy_params["mlp"], obs, done, cfg.activation,
                         backend, sp_axis)
    if discrete:
        logp_all = jax.nn.log_softmax(out, axis=-1)
        logp = jnp.take_along_axis(
            logp_all, action.astype(jnp.int32), axis=-1)[..., 0]
        ent = jnp.mean(-jnp.sum(jnp.exp(logp_all) * logp_all, axis=-1))
        return (logp, ent, hidden) if return_hidden else (logp, ent)
    log_std = policy_params["log_std"]
    logp = policy_mod.gaussian_log_prob_from_mean(out, log_std, action)
    k = action.shape[-1]
    ent = 0.5 * k * (1.0 + LOG_2PI) + jnp.sum(log_std)
    return (logp, ent, hidden) if return_hidden else (logp, ent)


# --------------------------------------------------------------------------
# update phases (sequence minibatches)
# --------------------------------------------------------------------------

def value_phase_rnn(cfg: PPOConfig, ts, traj, target: jax.Array, key,
                    axis_name, mb_size: int, v_old=None,
                    backend: str = "jnp", sp_axis: Optional[str] = None):
    """n_epochs_value shuffled passes fitting the recurrent V
    (src/ppo.cu:491-510 with sequence minibatches).  ``v_old`` ([T, E]
    rollout-time values) enables PPO2 value clipping (cfg.clip_value).
    Under sequence parallelism (``sp_axis``) the planes are time shards,
    every shard of an sp group runs the SAME env-column minibatches (the
    caller passes a group-common key) and ``axis_name`` is the (dp, sp)
    tuple the gradients pmean over."""
    from ppoc_tpu.algo import ppo as ppo_mod

    T, E = target.shape
    done = jnp.logical_or(traj.terminated, traj.truncated)
    seqs, n_mb = seq_minibatch_plan(E, _plan_T(T, sp_axis), mb_size)

    def loss_fn(v_params, o, d, t, vo=None):
        v = _seq_apply(v_params, o, d, cfg.activation, backend,
                       sp_axis)[..., 0]
        if vo is not None:
            return losses.clipped_value_loss(v, vo, t, cfg.clip_value)
        return losses.value_loss(v, t)

    cols = (traj.obs, done, target) if v_old is None \
        else (traj.obs, done, target, v_old)

    def mb_step(carry, idx):
        v_params, opt_v = carry
        mb = _gather_seqs(cols, idx)
        loss, grads = jax.value_and_grad(loss_fn)(v_params, *mb)
        grads = ppo_mod._prep_grads(grads, cfg, axis_name)
        v_params, opt_v = ppo_mod._value_adam_step(
            cfg, v_params, grads, opt_v, n_mb, axis_name)
        return (v_params, opt_v), loss

    def epoch(carry, key_e):
        return buffer.epoch_scan(key_e, E, n_mb, seqs, mb_step, carry)

    keys = jax.random.split(key, cfg.n_epochs_value)
    (v_params, opt_v), losses_ = jax.lax.scan(
        epoch, (ts.v_params, ts.opt_v), keys)
    return ts._replace(v_params=v_params, opt_v=opt_v), jnp.mean(losses_)


def policy_phase_rnn(cfg: PPOConfig, env: Env, ts, traj, adv: jax.Array, key,
                     axis_name, mb_size: int,
                     backend: str = "jnp", sp_axis: Optional[str] = None,
                     target: Optional[jax.Array] = None):
    """n_epochs_policy shuffled passes on the clipped surrogate
    (src/ppo.cu:512-533 with sequence minibatches + BPTT).  ``sp_axis``
    as in :func:`value_phase_rnn`.  ``target`` (the fit's value targets)
    engages the PPG-style auxiliary value loss on the policy trunk when
    cfg.aux_value_coeff > 0 and the trunk carries an aux head."""
    from ppoc_tpu.algo import ppo as ppo_mod

    T, E = adv.shape
    discrete = env.spec.discrete
    done = jnp.logical_or(traj.terminated, traj.truncated)
    seqs, n_mb = seq_minibatch_plan(E, _plan_T(T, sp_axis), mb_size)
    use_aux = (cfg.aux_value_coeff > 0.0 and target is not None
               and "aux_head" in ts.policy_params["mlp"])

    def loss_fn(policy_params, o, a, d, lp_old, ad, ent_c, tgt=None):
        if use_aux:
            logp, ent, hid = policy_log_probs_rnn(
                cfg, policy_params, o, a, d, discrete, backend, sp_axis,
                return_hidden=True)
        else:
            logp, ent = policy_log_probs_rnn(cfg, policy_params, o, a, d,
                                             discrete, backend, sp_axis)
        surrogate = losses.clipped_surrogate_loss(logp, lp_old, ad, cfg.clip_eps)
        loss = surrogate - ent_c * ent
        if use_aux:
            vhat = mlp.apply(policy_params["mlp"]["aux_head"], hid,
                             cfg.activation, "jnp")[..., 0]
            loss = loss + cfg.aux_value_coeff * jnp.mean(
                jnp.square(vhat - tgt))
        return loss, (ent, jnp.mean(lp_old - logp))

    use_kl = cfg.target_kl > 0.0

    def mb_step(carry, idx):
        if use_kl:
            policy_params, opt_policy, opt_log_std, stop = carry
        else:
            policy_params, opt_policy, opt_log_std = carry
        o, a, d, lp, ad = _gather_seqs(
            (traj.obs, traj.action, done, traj.log_prob, adv), idx)
        tgt = _gather_seqs((target,), idx)[0] if use_aux else None
        (loss, (ent, kl)), grads = jax.value_and_grad(loss_fn, has_aux=True)(
            policy_params, o, a, d, lp, ad,
            ppo_mod._ent_coeff(cfg, opt_policy, n_mb), tgt)
        grads = ppo_mod._prep_grads(grads, cfg, axis_name)
        new_params, new_opt_policy, new_opt_log_std = \
            ppo_mod._policy_adam_step(
                cfg, policy_params, grads, opt_policy, opt_log_std, n_mb,
                axis_name)
        if not use_kl:
            return (new_params, new_opt_policy, new_opt_log_std), (loss, ent)
        new_params = ppo_mod._freeze_where(stop, policy_params, new_params)
        new_opt_policy = ppo_mod._freeze_where(stop, opt_policy,
                                               new_opt_policy)
        new_opt_log_std = ppo_mod._freeze_where(stop, opt_log_std,
                                                new_opt_log_std)
        stop2 = jnp.logical_or(
            stop, ppo_mod._pmean(kl, axis_name) > cfg.target_kl)
        return (new_params, new_opt_policy, new_opt_log_std, stop2), (loss, ent)

    def epoch(carry, key_e):
        return buffer.epoch_scan(key_e, E, n_mb, seqs, mb_step, carry)

    carry0 = (ts.policy_params, ts.opt_policy, ts.opt_log_std)
    if use_kl:
        carry0 = carry0 + (jnp.zeros((), bool),)
    keys = jax.random.split(key, cfg.n_epochs_policy)
    carry_out, (losses_, ents) = jax.lax.scan(epoch, carry0, keys)
    policy_params, opt_policy, opt_log_std = carry_out[:3]
    ts = ts._replace(policy_params=policy_params, opt_policy=opt_policy,
                     opt_log_std=opt_log_std)
    return ts, jnp.mean(losses_), jnp.mean(ents)
