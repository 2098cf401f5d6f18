"""Sequence-parallel PPO: attention-trunk training over a (dp, sp) mesh.

The user-facing integration of the repo's two long-context collectives —
ring attention (parallel/ring_attn.py) and the time-sharded GAE merge
(parallel/sp.py, the cross-DEVICE form of the reference's cross-block
``gae_merge_kernel``, src/ppo.cu:215-251).  ``PPOConfig(attn_dim=D,
sp_size=N)`` trains the attention family with the rollout WINDOW itself
sharded over the ``sp`` mesh axis, so the trainable context scales past one
device's memory while the data axis keeps scaling over ``dp``.

Shape of one fit (everything inside one ``shard_map`` over the 2-D mesh,
one jitted program per epoch — the same invariant as every other mode):

1. **Rollout** is sequential in time (one KV-cache decode per env step), so
   it cannot time-shard; instead envs shard over the FLATTENED (dp, sp)
   mesh — every device collects ``n_envs/(dp*sp)`` columns of the [T, e]
   window with its own fold_in'd PRNG stream (with sp_size=1 this is
   bit-identical to the pure-dp fit_step).
2. **Reshard**: one tiled ``all_to_all`` over ``sp`` turns each device's
   [T, e] into [T/sp, e*sp] — sp rank i holds time block i of its dp
   group's whole env set.  This is the only moment the buffer crosses
   devices, once per fit.
3. **Values**: the parallel pass and the V(s') bootstrap decode run as ring
   attention with global positions/episode ids (models/attn.apply_seq_sp /
   decode_next_sp).
4. **GAE**: local log-depth scan + the T-independent affine-carry
   all_gather (parallel/sp.gae_sp); advantage normalization psums the
   Welford triple over BOTH axes.
5. **Update phases**: the standard sequence-minibatch machinery
   (algo/recurrent.py) with every sp rank of a dp group running the SAME
   env-column minibatches (group-common permutation key) on its time
   shard; gradients pmean over ("dp", "sp") — each rank contributes its
   T/sp slice of every sequence's BPTT, which is exactly the mean-loss
   gradient split by linearity.

Eval shards envs over the flat mesh like the rollout (no reshard needed).
"""
from __future__ import annotations

from typing import Optional, Tuple

import jax
import jax.numpy as jnp

from ppoc_tpu.config import PPOConfig
from ppoc_tpu.envs.core import Env
from ppoc_tpu.algo import ppo, recurrent
from ppoc_tpu.ops import gae as gae_ops, welford
from ppoc_tpu.parallel import sp as sp_mod


def _reshard_time(tree, sp_axis: str):
    """[T, e, ...] env-sharded planes -> [T/sp, e*sp, ...] time-sharded."""
    return jax.tree.map(
        lambda a: jax.lax.all_to_all(
            a, sp_axis, split_axis=0, concat_axis=1, tiled=True),
        tree,
    )


def fit_step_sp(
    cfg: PPOConfig,
    env: Env,
    ts: ppo.TrainState,
    key: jax.Array,
    dp_axis: str,
    sp_axis: str,
    n_envs_dp: int,
    mb_size: int,
) -> Tuple[ppo.TrainState, ppo.FitMetrics]:
    """One fit on the (dp, sp) mesh; ``n_envs_dp``/``mb_size`` are per-DP-
    GROUP sizes (the whole sp ring of a group works the same sequences).
    Every attention pass runs as XLA ring attention (float32)."""
    both = (dp_axis, sp_axis)
    sp_n = jax.lax.axis_size(sp_axis)
    n_envs_roll = n_envs_dp // sp_n

    # PRNG discipline: the rollout key folds the FLAT device index exactly
    # like ppo.fit_step folds the dp index (sp_size=1 degenerates to it
    # bit-for-bit); the update key folds the dp index only, so every sp
    # rank of a group draws the SAME minibatch permutations.
    k_dev = jax.random.fold_in(key, jax.lax.axis_index(both))
    k_roll, _ = jax.random.split(k_dev)
    k_grp = jax.random.fold_in(key, jax.lax.axis_index(dp_axis))
    _, k_upd = jax.random.split(k_grp)
    k_val, k_pol = jax.random.split(k_upd)

    traj, _ = recurrent.rollout_rnn(
        cfg, env, ts.policy_params, k_roll, n_envs_roll, cfg.rollout_len,
        axis_name=both,
    )
    traj = _reshard_time(traj, sp_axis)
    # type every plane varying over BOTH axes: planes an env computes from
    # constants (e.g. cartpole's reward = 1) otherwise reach the tuple
    # reductions typed varying over sp alone (the all_to_all) and fail the
    # vma check (same hazard ppo._pvary guards in the dp rollout)
    traj = ppo._pvary(traj, both)

    vpair = recurrent.compute_values_sp(cfg, ts.v_params, traj, sp_axis)
    adv, target = sp_mod.gae_sp(
        traj.reward, vpair[0], vpair[1], traj.terminated, traj.truncated,
        env.spec.gamma, cfg.lam, axis_name=sp_axis,
    )
    if cfg.norm_adv_global:
        mean, var = welford.mean_var(adv, both)
        adv = gae_ops.normalize(adv, mean, jnp.sqrt(var))

    ts, v_loss = recurrent.value_phase_rnn(
        cfg, ts, traj, target, k_val, both, mb_size,
        v_old=vpair[0] if cfg.clip_value > 0.0 else None,
        sp_axis=sp_axis,
    )
    ts, p_loss, ent = recurrent.policy_phase_rnn(
        cfg, env, ts, traj, adv, k_pol, both, mb_size, sp_axis=sp_axis,
    )
    mean_rew = jax.lax.pmean(jnp.mean(traj.reward), both)
    return ts, ppo.FitMetrics(
        jax.lax.pmean(v_loss, both), jax.lax.pmean(p_loss, both),
        jax.lax.pmean(ent, both), mean_rew,
    )


def train_epoch_sp(
    cfg: PPOConfig,
    env: Env,
    ts: ppo.TrainState,
    key: jax.Array,
    dp_axis: str,
    sp_axis: str,
    n_envs_dp: int,
    mb_size: int,
) -> Tuple[ppo.TrainState, ppo.FitMetrics]:
    """fits_per_epoch sequential sp fits as one scan (src/ppo.cu:479 loop;
    sequence trunks always reset per fit — config.validate enforces it)."""
    def one_fit(ts, key_f):
        return fit_step_sp(cfg, env, ts, key_f, dp_axis, sp_axis,
                           n_envs_dp, mb_size)

    keys = jax.random.split(key, cfg.fits_per_epoch)
    ts, metrics = jax.lax.scan(one_fit, ts, keys)
    return ts, jax.tree.map(jnp.mean, metrics)


def train_until_sp(
    cfg: PPOConfig,
    env: Env,
    ts: ppo.TrainState,
    key: jax.Array,
    target_R: float,
    max_epochs: int,
    dp_axis: str,
    sp_axis: str,
    n_envs_dp: int,
    mb_size: int,
    eval_envs_local: int,
) -> Tuple[ppo.TrainState, jax.Array, jax.Array]:
    """Train-until-threshold as ONE device program (ppo.train_until on the
    (dp, sp) mesh); returns (state, epochs_run, final_R)."""
    both = (dp_axis, sp_axis)

    def cond(carry):
        _, _, n, R = carry
        return jnp.logical_and(R < target_R, n < max_epochs)

    def body(carry):
        ts, key, n, _ = carry
        key, k_train, k_eval = jax.random.split(key, 3)
        ts, _ = train_epoch_sp(cfg, env, ts, k_train, dp_axis, sp_axis,
                               n_envs_dp, mb_size)
        ev = ppo.evaluate(cfg, env, ts.policy_params, k_eval, "jnp",
                          eval_envs_local, both)
        return ts, key, n + 1, ev.R

    ts, _, n, R = jax.lax.while_loop(
        cond, body, (ts, key, jnp.zeros((), jnp.int32), jnp.float32(-jnp.inf))
    )
    return ts, n, R
