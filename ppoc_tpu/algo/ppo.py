"""PPO: rollout collection, GAE, and the clipped-surrogate update.

Redesign of the reference algorithm layer (``src/ppo.cu``,
``include/ppo.h:30-47``).  The reference splits each "fit" across the host
(3000 single-env steps through an embedded CPython bridge,
``collect_trajectories`` src/ppo.cu:54-79) and the GPU (value/policy
minibatch epochs, ``_train_ppo_epoch_cuda`` src/ppo.cu:451-550) with bulk
buffer and weight copies in between.  Here the entire fit — vectorized
rollout, GAE, advantage normalization, 10 value epochs + 4 policy epochs of
minibatch Adam steps — is ONE jitted program: rollouts are a ``lax.scan``
over time stepping ``n_envs`` pure-JAX environments in lockstep, the update
phases are nested ``lax.scan``s over (epoch, minibatch), and nothing ever
leaves the device.

Semantics preserved from the reference (see SURVEY.md §7):
  * envs are reset at the start of every collection window (src/ppo.cu:55);
  * the final step of a window is force-marked truncated if not terminated
    (src/ppo.cu:70-74) so GAE never bootstraps across the window end;
  * advantages are normalized once per fit over the whole buffer with
    population std and eps=1e-8 (src/ppo.cu:355-368);
  * value targets are V(s) + A computed before normalization (src/ppo.cu:352);
  * each epoch reshuffles, minibatches are gathered by permutation index and
    the tail (< minibatch_size) is dropped (src/trajectory_buffer.cu:126-220,
    src/ppo.cu:475-477);
  * three separate Adam states (policy net, value net, log_std) with shared
    hyperparameters (src/ppo.cu:19-25).

Data parallelism: every function takes an optional ``axis_name``; when run
under ``shard_map`` over a mesh axis, cross-device reduction happens in
exactly two places — the whole-buffer advantage normalization and the
per-minibatch gradient ``pmean``.  Env state and rollout
data stay local to the device that generated them.
"""
from __future__ import annotations

import functools
from typing import Any, Dict, NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp

from ppoc_tpu.config import PPOConfig
from ppoc_tpu.data import buffer
from ppoc_tpu.envs.core import Env, vector_autoreset_step, vector_reset
from ppoc_tpu.models import mlp, policy as policy_mod
from ppoc_tpu.ops import adam, gae as gae_ops, losses, welford


class Transition(NamedTuple):
    obs: jax.Array        # [T, E, obs_dim]
    action: jax.Array     # [T, E, act_dim] (int32 [T, E, 1] if discrete)
    log_prob: jax.Array   # [T, E]
    next_obs: jax.Array   # [T, E, obs_dim]  true successor (pre-reset)
    reward: jax.Array     # [T, E]
    terminated: jax.Array # [T, E] bool
    truncated: jax.Array  # [T, E] bool


class TrainState(NamedTuple):
    policy_params: Dict[str, Any]
    v_params: Any
    opt_policy: adam.AdamState    # over policy_params["mlp"]
    opt_v: adam.AdamState         # over v_params
    opt_log_std: adam.AdamState   # over policy_params["log_std"] (empty tree if discrete)


class FitMetrics(NamedTuple):
    value_loss: jax.Array
    policy_loss: jax.Array
    entropy: jax.Array
    mean_reward: jax.Array


def _pmean(x, axis_name: Optional[str]):
    return jax.lax.pmean(x, axis_name) if axis_name is not None else x


def _device_key(key: jax.Array, axis_name: Optional[str]) -> jax.Array:
    """Give each data-parallel shard its own RNG stream."""
    if axis_name is None:
        return key
    return jax.random.fold_in(key, jax.lax.axis_index(axis_name))


def _prep_grads(grads, cfg: PPOConfig, axis_name: Optional[str]):
    """pmean across data-parallel shards, then (optionally) clip the global
    norm — shared by every update phase so the stabilizer can never apply
    to one phase and not another."""
    grads = _pmean(grads, axis_name)
    if cfg.max_grad_norm > 0.0:
        grads = adam.clip_by_global_norm(grads, cfg.max_grad_norm)
    return grads


def _anneal_factor(cfg: PPOConfig, opt_state, n_mb: int,
                   epochs_per_fit: int):
    """Remaining fraction of the cfg.n_epochs schedule, measured in the
    given optimizer's own Adam steps: 1 at the start, 0 at the end."""
    total = cfg.n_epochs * cfg.fits_per_epoch * epochs_per_fit * n_mb
    frac = opt_state.t.astype(jnp.float32) / jnp.float32(max(total, 1))
    return jnp.maximum(0.0, 1.0 - frac)


def _lr(base: float, cfg: PPOConfig, opt_state, n_mb: int,
        epochs_per_fit: int):
    """Effective learning rate: constant (reference) or linearly annealed to
    zero over the cfg.n_epochs schedule (cfg.lr_anneal)."""
    if not cfg.lr_anneal:
        return base
    return base * _anneal_factor(cfg, opt_state, n_mb, epochs_per_fit)


def _ent_coeff(cfg: PPOConfig, opt_state, n_mb: int):
    """Effective entropy-bonus coefficient: constant (reference) or linearly
    annealed to zero (cfg.ent_anneal) — the config-level form of the
    exploration-then-refinement staging the BipedalWalker recipe runs as
    two separate CLI invocations."""
    if not cfg.ent_anneal:
        return cfg.ent_coeff
    return cfg.ent_coeff * _anneal_factor(cfg, opt_state, n_mb,
                                          cfg.n_epochs_policy)


def _trunk_adam(cfg: PPOConfig, params, grads, opt, lr,
                axis_name: Optional[str]):
    """Adam on a trunk: the replicated pytree update, or — with cfg.zero1 on
    a mesh — the ZeRO-1 sharded step (per-rank moment slices + one
    all_gather of the updated params, ops/adam.update_zero1)."""
    if cfg.zero1 and axis_name is not None:
        return adam.update_zero1(
            params, grads, opt, lr,
            cfg.adam_beta1, cfg.adam_beta2, cfg.adam_eps, axis_name)
    return adam.update(params, grads, opt, lr,
                       cfg.adam_beta1, cfg.adam_beta2, cfg.adam_eps)


def _value_adam_step(cfg: PPOConfig, v_params, grads, opt_v, n_mb: int,
                     axis_name: Optional[str]):
    """One value minibatch's Adam update — shared by the feedforward and
    sequence value phases so the ZeRO-1 branch can never apply to one and
    not the other."""
    return _trunk_adam(
        cfg, v_params, grads, opt_v,
        _lr(cfg.lr_v, cfg, opt_v, n_mb, cfg.n_epochs_value), axis_name)


def _policy_adam_step(cfg: PPOConfig, policy_params, grads, opt_policy,
                      opt_log_std, n_mb: int,
                      axis_name: Optional[str] = None):
    """One policy minibatch's Adam updates — separate states for the mean
    net and log_std (src/ppo.cu:19-25), annealed lr — shared by the
    feedforward and recurrent phases.  The trunk state shards under
    cfg.zero1; log_std's stays replicated (it is action_dim floats)."""
    new_mlp, new_opt_policy = _trunk_adam(
        cfg, policy_params["mlp"], grads["mlp"], opt_policy,
        _lr(cfg.lr_policy, cfg, opt_policy, n_mb, cfg.n_epochs_policy),
        axis_name,
    )
    new_params = dict(policy_params)
    new_params["mlp"] = new_mlp
    new_opt_log_std = opt_log_std
    if "log_std" in policy_params:
        new_log_std, new_opt_log_std = adam.update(
            policy_params["log_std"], grads["log_std"], opt_log_std,
            _lr(cfg.lr_policy, cfg, opt_log_std, n_mb, cfg.n_epochs_policy),
            cfg.adam_beta1, cfg.adam_beta2, cfg.adam_eps,
        )
        new_params["log_std"] = new_log_std
    return new_params, new_opt_policy, new_opt_log_std


def _freeze_where(stop, old_tree, new_tree):
    """Element-wise select: keep ``old_tree`` where ``stop`` (the target_kl
    early-stop mask applied to params and optimizer states alike)."""
    return jax.tree.map(lambda o, n: jnp.where(stop, o, n), old_tree, new_tree)


def _pvary(tree, axis_name: Optional[str]):
    """Mark a pytree as device-varying along ``axis_name`` for shard_map's
    varying-axes type system.  Needed when an env's reset ignores its RNG key
    (e.g. the simple integrator), which would otherwise leave the rollout
    scan's initial carry replicated while the stepped carry is varying."""
    if axis_name is None:
        return tree

    from ppoc_tpu.parallel.mesh import type_varying

    def vary(x):
        try:
            if axis_name in jax.typeof(x).vma:
                return x  # already varying
        except AttributeError:
            pass
        return type_varying(x, axis_name)

    return jax.tree.map(vary, tree)


# --------------------------------------------------------------------------
# init
# --------------------------------------------------------------------------

def init_train_state(cfg: PPOConfig, env: Env, key: jax.Array) -> TrainState:
    """Build params + optimizer states (mirrors create_ppo, src/ppo.cu:6-35).

    With cfg.n_experts > 1 both trunks are mixture-of-experts
    (models/moe.py) instead of dense MLPs; every downstream consumer
    dispatches on the params structure (mlp.apply), so the rest of the
    algorithm is unchanged.
    """
    k_pi, k_v = jax.random.split(key)
    spec = env.spec
    if cfg.attn_dim > 0:
        from ppoc_tpu.models import attn

        # positional table must cover the longest window either program
        # rolls out (training fits use rollout_len, evaluation eval_len),
        # PLUS one slot so compute_values_rnn's next-token decode at the
        # final row gets position T instead of aliasing onto T-1 (which
        # would bias the force-truncated row's V(s') bootstrap)
        t_max = max(cfg.rollout_len, cfg.eval_len) + 1
        ff = cfg.attn_ff or 4 * cfg.attn_dim
        policy_params = {
            "mlp": attn.init(
                k_pi, spec.obs_dim, cfg.attn_dim, cfg.attn_layers,
                cfg.attn_heads, ff, t_max,
                (cfg.attn_dim, *cfg.hidden, spec.action_dim))
        }
        if cfg.aux_value_coeff > 0.0:
            # PPG-style auxiliary value head on the POLICY trunk
            # (cfg.aux_value_coeff): scalar regression head over the same
            # trunk output the action head reads; trained in the policy
            # phase (algo/recurrent.policy_phase_rnn), never used to act
            k_pi, k_aux = jax.random.split(k_pi)
            policy_params["mlp"]["aux_head"] = mlp.init(
                k_aux, (cfg.attn_dim, *cfg.hidden, 1))
        if not spec.discrete:
            policy_params["log_std"] = jnp.full(
                (spec.action_dim,), jnp.log(jnp.float32(cfg.init_std)),
                jnp.float32
            )
        v_params = attn.init(k_v, spec.obs_dim, cfg.attn_dim, cfg.attn_layers,
                             cfg.attn_heads, ff, t_max,
                             (cfg.attn_dim, *cfg.hidden, 1))
    elif cfg.rnn_hidden > 0:
        from ppoc_tpu.models import gru

        policy_params = {
            "mlp": gru.init(
                k_pi, spec.obs_dim, cfg.rnn_hidden,
                (cfg.rnn_hidden, *cfg.hidden, spec.action_dim),
                cell=cfg.rnn_cell)
        }
        if not spec.discrete:
            policy_params["log_std"] = jnp.full(
                (spec.action_dim,), jnp.log(jnp.float32(cfg.init_std)),
                jnp.float32
            )
        v_params = gru.init(k_v, spec.obs_dim, cfg.rnn_hidden,
                            (cfg.rnn_hidden, *cfg.hidden, 1),
                            cell=cfg.rnn_cell)
    elif cfg.n_experts > 1:
        from ppoc_tpu.models import moe

        policy_params = {
            "mlp": moe.init(
                k_pi, (spec.obs_dim, *cfg.hidden, spec.action_dim), cfg.n_experts
            )
        }
        if not spec.discrete:
            policy_params["log_std"] = jnp.full(
                (spec.action_dim,), jnp.log(jnp.float32(cfg.init_std)),
                jnp.float32
            )
        v_params = moe.init(k_v, (spec.obs_dim, *cfg.hidden, 1), cfg.n_experts)
    else:
        policy_params = policy_mod.init(
            k_pi, spec.obs_dim, spec.action_dim, cfg.hidden, cfg.init_std,
            spec.discrete,
        )
        # value net: same trunk, scalar head (src/ppo.cu:12-16)
        v_params = mlp.init(k_v, (spec.obs_dim, *cfg.hidden, 1))
    log_std_tree = policy_params.get("log_std", jnp.zeros((0,), jnp.float32))
    return TrainState(
        policy_params=policy_params,
        v_params=v_params,
        opt_policy=adam.init(policy_params["mlp"]),
        opt_v=adam.init(v_params),
        opt_log_std=adam.init(log_std_tree),
    )


# --------------------------------------------------------------------------
# rollout
# --------------------------------------------------------------------------

def rollout(
    cfg: PPOConfig,
    env: Env,
    policy_params: Dict[str, Any],
    key: jax.Array,
    n_envs: int,
    length: int,
    backend: str,
    axis_name: Optional[str] = None,
    env_carry=None,
    force_truncate: bool = True,
    deterministic: bool = False,
) -> Tuple[Transition, Any]:
    """Collect [length, n_envs] transitions; returns (traj, final env carry).

    Equivalent of collect_trajectories (src/ppo.cu:54-79) with the actor on
    device: the scan body fuses policy forward, sampling, env physics and
    auto-reset into one compiled step.  With ``env_carry=None`` envs are
    freshly reset at entry (the reference's behavior, src/ppo.cu:55);
    passing the previous rollout's carry continues the same episodes
    (cfg.reset_per_fit=False).
    """
    from ppoc_tpu.models import attn as _attn, gru as _gru

    if _gru.is_rnn(policy_params["mlp"]) or _attn.is_attn(policy_params["mlp"]):
        # sequence trunk (GRU/LSTM hidden-state scan or attention KV-cache
        # decode): algo/recurrent.py owns the state-threaded rollout
        from ppoc_tpu.algo import recurrent

        if env_carry is not None:
            raise ValueError(
                "sequence-trunk rollouts always start from a fresh window "
                "(zero hidden state / empty KV cache); reset_per_fit=False "
                "is not supported with rnn_hidden/attn_dim > 0"
            )
        return recurrent.rollout_rnn(
            cfg, env, policy_params, key, n_envs, length, axis_name,
            force_truncate=force_truncate, deterministic=deterministic,
        )

    k_reset, k_scan = jax.random.split(key)
    if env_carry is None:
        env_state, obs = _pvary(vector_reset(env, k_reset, n_envs), axis_name)
    else:
        env_state, obs = env_carry

    def step_fn(carry, key_t):
        env_state, obs = carry
        k_act, k_env = jax.random.split(key_t)
        if deterministic:
            action, log_prob = policy_mod.mode(
                policy_params, obs, cfg.activation, backend, env.spec.discrete
            )
        else:
            action, log_prob = policy_mod.sample(
                policy_params, obs, k_act, cfg.activation, backend,
                env.spec.discrete
            )
        env_state2, obs2, next_obs, reward, term, trunc = vector_autoreset_step(
            env, env_state, action, k_env
        )
        tr = Transition(obs, action, log_prob, next_obs, reward, term, trunc)
        return (env_state2, obs2), tr

    keys = jax.random.split(k_scan, length)
    final_carry, traj = jax.lax.scan(step_fn, (env_state, obs), keys)

    # Force-truncate the window end (src/ppo.cu:70-74) so GAE never
    # bootstraps across it.  NOTE this marks only the stored transition;
    # the carried env state continues the episode when reset_per_fit=False.
    # Evaluation passes force_truncate=False to keep the genuine done flags
    # (it needs to distinguish completed episodes from window-cut ones).
    if force_truncate:
        last_trunc = jnp.logical_or(
            traj.truncated[-1], jnp.logical_not(traj.terminated[-1])
        )
        traj = traj._replace(truncated=traj.truncated.at[-1].set(last_trunc))
    return traj, final_carry


# --------------------------------------------------------------------------
# advantages
# --------------------------------------------------------------------------

def compute_advantages(
    cfg: PPOConfig,
    env: Env,
    v_params,
    traj: Transition,
    axis_name: Optional[str],
    backend: str,
    values_pair=None,
) -> Tuple[jax.Array, jax.Array]:
    """GAE + whole-buffer normalization (compute_gae_cuda, src/ppo.cu:261-323).

    Returns (normalized advantages, value targets), both [T, E].
    ``values_pair`` supplies precomputed (V(s), V(s')) planes (sequence
    trunks' history-aware pass, or the rollout-time values PPO2 value
    clipping keeps), replacing the two whole-buffer forwards below
    (reference: src/ppo.cu:267-274).
    """
    if values_pair is not None:
        values, next_values = values_pair
    else:
        values = mlp.apply(v_params, traj.obs, cfg.activation, backend)[..., 0]
        next_values = mlp.apply(
            v_params, traj.next_obs, cfg.activation, backend)[..., 0]
    adv, target = gae_ops.gae(
        traj.reward, values, next_values, traj.terminated, traj.truncated,
        env.spec.gamma, cfg.lam,
    )
    if cfg.norm_adv_global:
        # Streaming pairwise Welford (ops/welford.py), merged across
        # data-parallel shards by exchanging only (n, mean, M2) triples —
        # the one collective the data phase needs (reference: welford_var.h
        # reduction at src/ppo.cu:299-316).
        mean, var = welford.mean_var(adv, axis_name)
        adv = gae_ops.normalize(adv, mean, jnp.sqrt(var))
    return adv, target


# --------------------------------------------------------------------------
# update phases
# --------------------------------------------------------------------------

def value_phase(cfg: PPOConfig, ts: TrainState, buf: buffer.RowBuffer, key,
                axis_name: Optional[str], backend: str, n_mb: int,
                mb_size: int):
    """n_epochs_value shuffled passes fitting V (src/ppo.cu:491-510): nested
    scans over (epoch, minibatch) of forward + backward + Adam; under data
    parallelism the minibatch gradient pmeans across shards before Adam."""
    from ppoc_tpu.models import moe as _moe

    n_rows = buf.obs.shape[0]
    aux_coeff, moe_topk = _moe.aux_setup(cfg, ts.v_params, backend)

    clip_v = cfg.clip_value

    def loss_fn(v_params, o, t, vo=None):
        v = mlp.apply(v_params, o, cfg.activation, backend)[..., 0]
        if clip_v > 0.0:
            loss = losses.clipped_value_loss(v, vo, t, clip_v)
        else:
            loss = losses.value_loss(v, t)
        if aux_coeff:
            loss = loss + aux_coeff * _moe.load_balance_loss(
                v_params, o, moe_topk)
        return loss

    cols = (buf.obs, buf.target) if clip_v == 0.0 \
        else (buf.obs, buf.target, buf.v_old)

    blk = cfg.shuffle_block

    def mb_step(carry, idx):
        v_params, opt_v = carry
        mb = buffer.gather_mb(cols, idx, blk)
        loss, grads = jax.value_and_grad(loss_fn)(v_params, *mb)
        grads = _prep_grads(grads, cfg, axis_name)
        v_params, opt_v = _value_adam_step(
            cfg, v_params, grads, opt_v, n_mb, axis_name)
        return (v_params, opt_v), loss

    def epoch(carry, key_e):
        return buffer.epoch_scan(key_e, n_rows, n_mb, mb_size, mb_step,
                                 carry, blk)

    keys = jax.random.split(key, cfg.n_epochs_value)
    (v_params, opt_v), losses_ = jax.lax.scan(epoch, (ts.v_params, ts.opt_v), keys)
    return ts._replace(v_params=v_params, opt_v=opt_v), jnp.mean(losses_)


def policy_phase(cfg: PPOConfig, env: Env, ts: TrainState, buf: buffer.RowBuffer,
                 key, axis_name: Optional[str],
                 backend: str, n_mb: int, mb_size: int):
    """n_epochs_policy shuffled passes on the clipped surrogate
    (src/ppo.cu:512-533)."""
    n_rows = buf.obs.shape[0]
    discrete = env.spec.discrete
    from ppoc_tpu.models import moe as _moe

    aux_coeff, moe_topk = _moe.aux_setup(cfg, ts.policy_params["mlp"], backend)

    def loss_fn(policy_params, o, a, lp_old, adv, ent_c):
        logp = policy_mod.log_prob(policy_params, o, a, cfg.activation, backend, discrete)
        surrogate = losses.clipped_surrogate_loss(logp, lp_old, adv, cfg.clip_eps)
        ent = policy_mod.entropy(policy_params, o, cfg.activation, backend, discrete)
        loss = surrogate - ent_c * ent
        if aux_coeff:
            loss = loss + aux_coeff * _moe.load_balance_loss(
                policy_params["mlp"], o, moe_topk)
        # approx KL (E[old - new logp]) for the target_kl early stop
        return loss, (ent, jnp.mean(lp_old - logp))

    use_kl = cfg.target_kl > 0.0

    def mb_step(carry, idx):
        if use_kl:
            policy_params, opt_policy, opt_log_std, stop = carry
        else:
            policy_params, opt_policy, opt_log_std = carry
        o, a, lp, ad = buffer.gather_mb(
            (buf.obs, buf.action, buf.log_prob, buf.advantage), idx,
            cfg.shuffle_block
        )
        (loss, (ent, kl)), grads = jax.value_and_grad(loss_fn, has_aux=True)(
            policy_params, o, a, lp, ad, _ent_coeff(cfg, opt_policy, n_mb)
        )
        grads = _prep_grads(grads, cfg, axis_name)
        new_params, new_opt_policy, new_opt_log_std = _policy_adam_step(
            cfg, policy_params, grads, opt_policy, opt_log_std, n_mb,
            axis_name)
        if not use_kl:
            return (new_params, new_opt_policy, new_opt_log_std), (loss, ent)
        # once a minibatch's (dp-agreed) KL breaches the target, every later
        # update in this fit is a no-op: params and optimizers freeze
        new_params = _freeze_where(stop, policy_params, new_params)
        new_opt_policy = _freeze_where(stop, opt_policy, new_opt_policy)
        new_opt_log_std = _freeze_where(stop, opt_log_std, new_opt_log_std)
        stop2 = jnp.logical_or(stop, _pmean(kl, axis_name) > cfg.target_kl)
        return (new_params, new_opt_policy, new_opt_log_std, stop2), (loss, ent)

    def epoch(carry, key_e):
        return buffer.epoch_scan(key_e, n_rows, n_mb, mb_size, mb_step,
                                 carry, cfg.shuffle_block)

    carry0 = (ts.policy_params, ts.opt_policy, ts.opt_log_std)
    if use_kl:
        carry0 = carry0 + (jnp.zeros((), bool),)
    keys = jax.random.split(key, cfg.n_epochs_policy)
    carry_out, (losses_, ents) = jax.lax.scan(epoch, carry0, keys)
    policy_params, opt_policy, opt_log_std = carry_out[:3]
    ts = ts._replace(
        policy_params=policy_params, opt_policy=opt_policy, opt_log_std=opt_log_std
    )
    return ts, jnp.mean(losses_), jnp.mean(ents)


# --------------------------------------------------------------------------
# fit step / train epoch
# --------------------------------------------------------------------------

def update_step(
    cfg: PPOConfig,
    env: Env,
    ts: TrainState,
    traj: Transition,
    key: jax.Array,
    axis_name: Optional[str] = None,
    mb_size: Optional[int] = None,
    backend: str = "jnp",
) -> Tuple[TrainState, FitMetrics]:
    """Learner half of a fit: GAE + advantage normalization + value/policy
    epochs on an already-collected trajectory (the work of
    _train_ppo_epoch_cuda after buffer_to_device, src/ppo.cu:485-533).

    Used by :func:`fit_step` with on-device rollouts and by the Gymnasium
    host bridge (ppoc_tpu.envs.gym_bridge) with host-collected ones —
    ``env`` only contributes its spec (gamma, discrete).
    """
    mb_size = cfg.minibatch_size if mb_size is None else mb_size
    n_mb = cfg.num_minibatches  # identical globally and per shard
    k_val, k_pol = jax.random.split(key)

    from ppoc_tpu.models import attn as _attn, gru as _gru

    if _gru.is_rnn(ts.v_params) or _attn.is_attn(ts.v_params):
        # sequence trunks (recurrent or attention): values from the
        # history-aware pass, then sequence minibatches (algo/recurrent.py);
        # row shuffling would destroy the history they need
        from ppoc_tpu.algo import recurrent

        vpair = recurrent.compute_values_rnn(cfg, ts.v_params, traj,
                                             backend=backend)
        adv, target = compute_advantages(
            cfg, env, ts.v_params, traj, axis_name, "jnp", vpair)
        ts, v_loss = recurrent.value_phase_rnn(
            cfg, ts, traj, target, k_val, axis_name, mb_size,
            v_old=vpair[0] if cfg.clip_value > 0.0 else None,
            backend=backend)
        ts, p_loss, ent = recurrent.policy_phase_rnn(
            cfg, env, ts, traj, adv, k_pol, axis_name, mb_size,
            backend=backend,
            target=target if cfg.aux_value_coeff > 0.0 else None)
        mean_rew = _pmean(jnp.mean(traj.reward), axis_name)
        return ts, FitMetrics(
            _pmean(v_loss, axis_name), _pmean(p_loss, axis_name),
            _pmean(ent, axis_name), mean_rew,
        )

    values_pair = None
    if cfg.clip_value > 0.0:
        # PPO2 value clipping needs the rollout-time V(s) rows; materialize
        # the planes here so compute_advantages reuses them for free
        values_pair = (
            mlp.apply(ts.v_params, traj.obs, cfg.activation, backend)[..., 0],
            mlp.apply(ts.v_params, traj.next_obs, cfg.activation,
                      backend)[..., 0],
        )
    adv, target = compute_advantages(
        cfg, env, ts.v_params, traj, axis_name, backend, values_pair)
    buf = buffer.from_rollout(
        traj, adv, target,
        v_old=values_pair[0] if cfg.clip_value > 0.0 else None)

    ts, v_loss = value_phase(
        cfg, ts, buf, k_val, axis_name, backend, n_mb, mb_size)
    ts, p_loss, ent = policy_phase(
        cfg, env, ts, buf, k_pol, axis_name, backend, n_mb, mb_size)
    mean_rew = _pmean(jnp.mean(traj.reward), axis_name)
    # pmean the scalar diagnostics so they are replicated across shards
    return ts, FitMetrics(
        _pmean(v_loss, axis_name), _pmean(p_loss, axis_name),
        _pmean(ent, axis_name), mean_rew,
    )


def fit_step(
    cfg: PPOConfig,
    env: Env,
    ts: TrainState,
    key: jax.Array,
    axis_name: Optional[str] = None,
    n_envs: Optional[int] = None,
    mb_size: Optional[int] = None,
    backend: str = "jnp",
    env_carry=None,
    return_env_carry: bool = False,
):
    """One fit: collect steps_per_fit transitions, GAE, value+policy epochs.

    ``n_envs`` / ``mb_size`` override the config with per-device (local)
    sizes when running under shard_map.  ``env_carry``/``return_env_carry``
    thread persistent env state across fits (cfg.reset_per_fit=False).
    """
    n_envs = cfg.n_envs if n_envs is None else n_envs
    key = _device_key(key, axis_name)
    k_roll, k_upd = jax.random.split(key)
    traj, env_carry = rollout(
        cfg, env, ts.policy_params, k_roll, n_envs, cfg.rollout_len, backend,
        axis_name, env_carry,
    )
    ts, metrics = update_step(
        cfg, env, ts, traj, k_upd, axis_name, mb_size, backend)
    return (ts, env_carry, metrics) if return_env_carry else (ts, metrics)


def train_fits(
    cfg: PPOConfig,
    env: Env,
    ts: TrainState,
    keys: jax.Array,          # [N, 2] per-fit keys (pre-split)
    axis_name: Optional[str] = None,
    n_envs: Optional[int] = None,
    mb_size: Optional[int] = None,
    backend: str = "jnp",
    env_carry=None,
):
    """Scan ``fit_step`` over a pre-split [N] key batch.

    The scan body of :func:`train_epoch`, factored out so the epoch can be
    compiled either as ONE fused N=fits_per_epoch program (the default) or
    as bounded-size chunks (cfg.fits_per_program — same key stream fed in
    slices, bit-identical training).  ``env_carry`` threads persistent env
    state (cfg.reset_per_fit=False); pass None for reset-per-fit fits.
    Returns ``(ts, env_carry_or_None, metrics)`` with metrics meaned over
    the N fits.
    """
    if env_carry is None:
        def one_fit(ts, key_f):
            return fit_step(cfg, env, ts, key_f, axis_name, n_envs,
                            mb_size, backend)

        ts, metrics = jax.lax.scan(one_fit, ts, keys)
        return ts, None, jax.tree.map(jnp.mean, metrics)

    def one_fit(carry, key_f):
        ts, env_carry = carry
        ts, env_carry, metrics = fit_step(
            cfg, env, ts, key_f, axis_name, n_envs, mb_size, backend,
            env_carry=env_carry, return_env_carry=True,
        )
        return (ts, env_carry), metrics

    (ts, env_carry), metrics = jax.lax.scan(one_fit, (ts, env_carry), keys)
    return ts, env_carry, jax.tree.map(jnp.mean, metrics)


def reset_env_carry(cfg: PPOConfig, env: Env, key: jax.Array,
                    axis_name: Optional[str] = None,
                    n_envs: Optional[int] = None):
    """The epoch-entry env reset of the reset_per_fit=False branch, exposed
    as its own program for the chunked-epoch dispatch path."""
    local_envs = cfg.n_envs if n_envs is None else n_envs
    key = _device_key(key, axis_name)
    return _pvary(vector_reset(env, key, local_envs), axis_name)


def train_epoch(
    cfg: PPOConfig,
    env: Env,
    ts: TrainState,
    key: jax.Array,
    axis_name: Optional[str] = None,
    n_envs: Optional[int] = None,
    mb_size: Optional[int] = None,
    backend: str = "jnp",
) -> Tuple[TrainState, FitMetrics]:
    """fits_per_epoch sequential fits as one scan (src/ppo.cu:479 loop).

    With cfg.reset_per_fit=False (no reference counterpart — the reference
    always resets, src/ppo.cu:55), envs reset once at epoch entry and then
    persist across fits: episodes continue where the previous rollout window
    left them, so long-horizon envs are not forever stuck in their opening
    phase.
    """
    if cfg.reset_per_fit:
        keys = jax.random.split(key, cfg.fits_per_epoch)
        ts, _, metrics = train_fits(cfg, env, ts, keys, axis_name, n_envs,
                                    mb_size, backend)
        return ts, metrics

    k_reset, key = jax.random.split(key)
    env_carry = reset_env_carry(cfg, env, k_reset, axis_name, n_envs)
    keys = jax.random.split(key, cfg.fits_per_epoch)
    ts, _, metrics = train_fits(cfg, env, ts, keys, axis_name, n_envs,
                                mb_size, backend, env_carry=env_carry)
    return ts, metrics


def train_until(
    cfg: PPOConfig,
    env: Env,
    ts: TrainState,
    key: jax.Array,
    target_R: float,
    max_epochs: int,
    axis_name: Optional[str] = None,
    n_envs: Optional[int] = None,
    mb_size: Optional[int] = None,
    backend: str = "jnp",
    eval_envs: Optional[int] = None,
) -> Tuple[TrainState, jax.Array, jax.Array]:
    """Train until stochastic-eval mean return reaches ``target_R`` — as ONE
    device program (`lax.while_loop` over train-epoch + eval), so the whole
    run costs a single host dispatch.

    The reference's equivalent loop lives on the host (src/main.c:50-56,
    one train + eval round trip per epoch); on an accelerator those round
    trips dominate sub-second solves, so the loop compiles onto the
    device.
    Returns (state, epochs_run, final_R).
    """
    def cond(carry):
        _, _, n, R = carry
        return jnp.logical_and(R < target_R, n < max_epochs)

    def body(carry):
        ts, key, n, _ = carry
        key, k_train, k_eval = jax.random.split(key, 3)
        ts, _ = train_epoch(cfg, env, ts, k_train, axis_name, n_envs, mb_size, backend)
        ev = evaluate(cfg, env, ts.policy_params, k_eval, backend, eval_envs, axis_name)
        return ts, key, n + 1, ev.R

    ts, _, n, R = jax.lax.while_loop(
        cond, body, (ts, key, jnp.zeros((), jnp.int32), jnp.float32(-jnp.inf))
    )
    return ts, n, R


# --------------------------------------------------------------------------
# evaluation
# --------------------------------------------------------------------------

class EvalMetrics(NamedTuple):
    J: jax.Array           # mean discounted episode return
    R: jax.Array           # mean undiscounted episode return
    episodes: jax.Array    # episode count


def eval_metrics_from_traj(
    traj: Transition, gamma: float, axis_name: Optional[str] = None
) -> EvalMetrics:
    """Episode metrics from a trajectory with GENUINE done flags.

    Counts only episodes that COMPLETE within the window: a segment cut off
    by the window end would otherwise report a partial return, which for
    envs with horizon > eval window (e.g. CartPole's 500 vs a 200-step eval)
    systematically deflates R and makes solve thresholds unreachable.  The
    reference instead drops the OLDEST episode from sum_J and counts cut
    ones (src/ppo.cu:571-579, SURVEY.md §3.4) — a quirk, not replicated
    here; the opt-in PPOConfig(eval_estimator="reference") selects
    eval_metrics_reference, which reproduces it exactly for parity tables.
    Shared by the on-device evaluate() and the host-bridge trainer.
    """
    done = jnp.logical_or(traj.terminated, traj.truncated)
    j_t = gae_ops.discounted_episode_returns(traj.reward, done, gamma)
    r_t = gae_ops.discounted_episode_returns(traj.reward, done, 1.0)
    starts = jnp.concatenate([jnp.ones_like(done[:1]), done[:-1]], axis=0)
    # a step's segment completes iff some done exists at s >= t (per env):
    # reversed-time cumulative OR of the done flags
    completed = jnp.flip(
        jnp.cumsum(jnp.flip(done.astype(jnp.float32), 0), axis=0), 0
    ) > 0
    mask = (starts & completed).astype(jnp.float32)
    n_eps = jnp.sum(done.astype(jnp.float32))
    sum_j = jnp.sum(j_t * mask)
    sum_r = jnp.sum(r_t * mask)
    if axis_name is not None:
        n_eps = jax.lax.psum(n_eps, axis_name)
        sum_j = jax.lax.psum(sum_j, axis_name)
        sum_r = jax.lax.psum(sum_r, axis_name)
    denom = jnp.maximum(n_eps, 1.0)
    # 0 completed episodes => J = R = -inf, NOT 0: for negative-return envs
    # (pendulum/acrobot targets < 0) a 0 would read as instantly "solved"
    # whenever eval_len < the env horizon; -inf keeps train_until/stop_at_R
    # training instead.
    none = n_eps == 0.0
    neg_inf = jnp.float32(-jnp.inf)
    return EvalMetrics(
        J=jnp.where(none, neg_inf, sum_j / denom),
        R=jnp.where(none, neg_inf, sum_r / denom),
        episodes=n_eps,
    )


def eval_metrics_reference(
    traj: Transition, gamma: float, axis_name: Optional[str] = None
) -> EvalMetrics:
    """The reference's EXACT eval estimator (src/ppo.cu:560-583), applied
    per env stream and pooled.

    Reproduced semantics, per stream of T steps: ``rewards`` sums ALL
    rewards; the backward walk starts episode_J at r[T-1] and for
    i = T-2..0 accumulates episode_J = r[i] + gamma*episode_J BEFORE
    checking done[i] — so each recorded J mixes the earlier episode's last
    reward into the later one (src/ppo.cu:572-578); n_episodes starts at 1
    (the window-cut final segment counts; the final step's own done marker
    is never examined) and increments per interior done; the
    chronologically FIRST segment's J is accumulated but never summed
    (the "dropped oldest episode").  R = sum(rewards)/n_episodes therefore
    counts partial window-cut segments — deflating R on envs whose horizon
    exceeds the eval window, which is why "completed" is the default
    (eval_metrics_from_traj).  Pooling across E env streams mirrors E
    independent reference buffers: J = sum_e sum_J_e / sum_e n_e,
    R = sum_e rewards_e / sum_e n_e.
    """
    T = traj.reward.shape[0]
    done = jnp.logical_or(traj.terminated, traj.truncated)
    rewards = jnp.sum(traj.reward, axis=0)            # [E]
    ep_j0 = traj.reward[T - 1].astype(jnp.float32)    # episode_J seed

    def step(carry, inp):
        ep_j, sum_j = carry
        r_i, d_i = inp
        ep_j = r_i + gamma * ep_j                     # BEFORE the done check
        sum_j = sum_j + jnp.where(d_i, ep_j, 0.0)
        ep_j = jnp.where(d_i, 0.0, ep_j)
        return (ep_j, sum_j), None

    # walk i = T-2 .. 0 (the reference loop; reversed-time scan)
    (_, sum_j), _ = jax.lax.scan(
        step, (ep_j0, jnp.zeros_like(ep_j0)),
        (jnp.flip(traj.reward[: T - 1].astype(jnp.float32), 0),
         jnp.flip(done[: T - 1], 0)),
    )
    n_eps = 1.0 + jnp.sum(done[: T - 1].astype(jnp.float32), axis=0)  # [E]
    n_total = jnp.sum(n_eps)
    sum_j_total = jnp.sum(sum_j)
    sum_r_total = jnp.sum(rewards)
    if axis_name is not None:
        n_total = jax.lax.psum(n_total, axis_name)
        sum_j_total = jax.lax.psum(sum_j_total, axis_name)
        sum_r_total = jax.lax.psum(sum_r_total, axis_name)
    return EvalMetrics(
        J=sum_j_total / n_total,
        R=sum_r_total / n_total,
        episodes=n_total,
    )


def evaluate(
    cfg: PPOConfig,
    env: Env,
    policy_params: Dict[str, Any],
    key: jax.Array,
    backend: str = "jnp",
    n_envs: Optional[int] = None,
    axis_name: Optional[str] = None,
    deterministic: bool = False,
) -> EvalMetrics:
    """Stochastic-policy evaluation (eval_ppo, src/ppo.cu:560-583) by
    default; ``deterministic=True`` rolls out the distribution mode (the
    mean-policy protocol benchmark scores use).

    Reports mean discounted return J, mean undiscounted return R and the
    completed-episode count (see eval_metrics_from_traj).  For meaningful
    numbers use cfg.eval_len >= the env's horizon so episodes can finish.
    """
    n_envs = cfg.eval_envs if n_envs is None else n_envs
    key = _device_key(key, axis_name)
    reference_est = getattr(cfg, "eval_estimator", "completed") == "reference"
    traj, _ = rollout(
        cfg, env, policy_params, key, n_envs, cfg.eval_len, backend, axis_name,
        force_truncate=False, deterministic=deterministic,
    )
    if reference_est:
        return eval_metrics_reference(traj, env.spec.gamma, axis_name)
    return eval_metrics_from_traj(traj, env.spec.gamma, axis_name)
