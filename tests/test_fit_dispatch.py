"""Phased fit dispatch (PPOConfig.fit_dispatch="phased").

A compile-size option below fits_per_program's epoch chunking: the
phased mode compiles the sequence-trunk fit's four stages (rollout /
values+GAE / value phase / policy phase) as separate programs over the
fused fit's exact key stream.  The correctness contract: the UN-JITTED composition is
bit-equal to ppo.fit_step (logic identity); across the new jit
boundaries XLA's fusion (FMA) rounding may differ at ulp level, so the
jitted comparison pins single-epoch metrics closeness, not bit equality.
"""
import jax
import numpy as np
import pytest

from ppoc_tpu import PPOConfig, Trainer
from ppoc_tpu import config as config_mod
from ppoc_tpu.algo import ppo, recurrent


def _cfg(**kw):
    base = dict(env="recall", n_envs=8, rollout_len=6, minibatch_size=48,
                fits_per_epoch=3, eval_envs=16, eval_len=6, hidden=(16,),
                seed=0, attn_dim=8, attn_layers=1, attn_heads=2)
    base.update(kw)
    return PPOConfig(**base)


def _eq(a, b):
    return all(np.array_equal(np.asarray(x), np.asarray(y))
               for x, y in zip(jax.tree.leaves(a), jax.tree.leaves(b)))


@pytest.mark.parametrize("extra", [{}, {"aux_value_coeff": 1.0},
                                   {"clip_value": 0.2}])
def test_unjitted_phase_composition_bit_equals_fit_step(extra):
    """The phased driver's stage functions, composed eagerly with the
    phased key splits, reproduce ppo.fit_step bit-for-bit — the logic
    identity that underwrites the mode."""
    tr = Trainer(_cfg(**extra))
    cfg, env, ts = tr.cfg, tr.env, tr.state
    key = jax.random.PRNGKey(42)
    ts_f, m_f = ppo.fit_step(cfg, env, ts, key, None, None, None, tr.backend)

    k_roll, k_upd = jax.random.split(key)
    k_val, k_pol = jax.random.split(k_upd)
    traj, _c = ppo.rollout(cfg, env, ts.policy_params, k_roll,
                           cfg.n_envs, cfg.rollout_len, tr.backend)
    sb = tr.backend
    vpair = recurrent.compute_values_rnn(cfg, ts.v_params, traj, backend=sb)
    adv, target = ppo.compute_advantages(cfg, env, ts.v_params, traj,
                                         None, "jnp", vpair)
    ts_p, v_loss = recurrent.value_phase_rnn(
        cfg, ts, traj, target, k_val, None, cfg.minibatch_size,
        v_old=vpair[0] if cfg.clip_value > 0.0 else None, backend=sb)
    ts_p, p_loss, ent = recurrent.policy_phase_rnn(
        cfg, env, ts_p, traj, adv, k_pol, None, cfg.minibatch_size,
        backend=sb,
        target=target if cfg.aux_value_coeff > 0.0 else None)
    assert _eq(ts_f, ts_p)
    np.testing.assert_array_equal(np.asarray(m_f.value_loss),
                                  np.asarray(v_loss))
    np.testing.assert_array_equal(np.asarray(m_f.policy_loss),
                                  np.asarray(p_loss))


def test_jitted_phased_tracks_fused():
    """Through the Trainer (jitted stage programs): single-epoch metrics
    agree to fusion-rounding tolerance and training proceeds."""
    t_f = Trainer(_cfg())
    t_p = Trainer(_cfg(fit_dispatch="phased"))
    m_f = t_f.train_epoch()
    m_p = t_p.train_epoch()
    np.testing.assert_allclose(np.asarray(jax.tree.leaves(m_p)),
                               np.asarray(jax.tree.leaves(m_f)), rtol=1e-4)
    assert np.isfinite(t_p.evaluate().R)


def test_phased_with_gru():
    tr = Trainer(_cfg(attn_dim=0, rnn_hidden=8, fit_dispatch="phased"))
    tr.train_epoch()
    assert np.isfinite(tr.evaluate().R)


def test_rollout_chunk_tracks_monolithic():
    """Segmented decode (rollout_chunk): same per-step key stream as the
    monolithic scan — training metrics and evals agree; deterministic
    eval runs through the chunked evaluator too."""
    t_m = Trainer(_cfg(fit_dispatch="phased"))
    t_c = Trainer(_cfg(fit_dispatch="phased", rollout_chunk=2))
    m_m = t_m.train_epoch()
    m_c = t_c.train_epoch()
    np.testing.assert_allclose(np.asarray(jax.tree.leaves(m_c)),
                               np.asarray(jax.tree.leaves(m_m)), rtol=1e-5)
    assert t_c.evaluate().R == pytest.approx(t_m.evaluate().R, abs=1e-6)
    assert np.isfinite(t_c.evaluate(deterministic=True).R)


def test_rollout_chunk_validation():
    from ppoc_tpu import config as config_mod

    with pytest.raises(ValueError, match="phased"):
        config_mod.validate(_cfg(rollout_chunk=2))
    with pytest.raises(ValueError, match="divide"):
        config_mod.validate(_cfg(fit_dispatch="phased", rollout_chunk=4))


def test_validation():
    with pytest.raises(ValueError, match="SEQUENCE-trunk"):
        config_mod.validate(PPOConfig(env="pendulum", fit_dispatch="phased"))
    with pytest.raises(ValueError, match="fused.*phased|phased.*fused"):
        config_mod.validate(PPOConfig(env="pendulum", fit_dispatch="bogus"))
    with pytest.raises(ValueError, match="fits_per_program"):
        config_mod.validate(_cfg(fit_dispatch="phased", fits_per_program=1))
    with pytest.raises(ValueError, match="single-device"):
        config_mod.validate(_cfg(fit_dispatch="phased", sp_size=2,
                                 rollout_len=8))
