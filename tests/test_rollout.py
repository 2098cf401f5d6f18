"""The on-device rollout (algo/ppo.rollout, a ``lax.scan`` of policy
sample + vectorized env step + auto-reset) against independent oracles.

Physics: every transition the XLA rollout records must be reproduced by
the C++ engine (ppoc_tpu/native, the independent physics oracle) started
from the same reset state and fed the same actions, step for step, until
the first episode ends (the engines' auto-reset draws differ).  Policy:
stored log-probs equal a fresh recomputation, sampled actions follow the
policy's distribution, and the window bookkeeping (force-truncation, carry
continuation, horizon auto-reset, evaluation metrics) holds.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from ppoc_tpu import PPOConfig, envs, native
from ppoc_tpu.algo import ppo
from ppoc_tpu.envs.core import vector_reset
from ppoc_tpu.models import policy as policy_mod

ORACLE_ENVS = ["pendulum", "simple", "cartpole", "mountain_car", "acrobot",
               "reacher", "recall"]


def _native_state(name, st):
    """The C++ engine's [n, state_dim] physics matrix for a JAX env state."""
    a = lambda x: np.asarray(x, np.float32)
    if name == "pendulum":
        return np.stack([a(st.theta), a(st.theta_dot)], 1)
    if name == "cartpole":
        return np.stack([a(st.x), a(st.x_dot), a(st.theta),
                         a(st.theta_dot)], 1)
    if name == "mountain_car":
        return np.stack([a(st.position), a(st.velocity)], 1)
    if name == "simple":
        return a(st.s)[:, None]
    if name == "acrobot":
        return a(st.s)
    if name == "reacher":
        return np.concatenate([a(st.q), a(st.qd), a(st.target)], 1)
    if name == "recall":
        return np.stack([a(st.b), (np.asarray(st.t) == 0).astype(np.float32)],
                        1)
    raise KeyError(name)


def _rollout(name, n=8, T=24, seed=1, **cfg_kw):
    cfg = PPOConfig(env=name, n_envs=n, rollout_len=T, **cfg_kw)
    env = envs.make(name)
    ts = ppo.init_train_state(cfg, env, jax.random.PRNGKey(0))
    key = jax.random.PRNGKey(seed)
    traj, carry = jax.jit(lambda pp, k: ppo.rollout(
        cfg, env, pp, k, n, T, "jnp"))(ts.policy_params, key)
    return cfg, env, ts, key, traj, carry


@pytest.mark.skipif(not native.available(),
                    reason="native library unavailable (no g++)")
@pytest.mark.parametrize("name", ORACLE_ENVS)
def test_rollout_matches_native_physics(name):
    n, T = 8, 24
    cfg, env, ts, key, traj, _ = _rollout(name, n, T)
    # the rollout's own reset: same key split as ppo.rollout
    k_reset, _ = jax.random.split(key)
    st0, obs0 = vector_reset(env, k_reset, n)
    np.testing.assert_allclose(np.asarray(traj.obs[0]), np.asarray(obs0),
                               rtol=1e-6)
    nat = native.NativeVecEnv(name, n)
    nat.reset(seed=0)
    nat.set_state(_native_state(name, st0), np.zeros(n, np.int32))
    actions = np.asarray(traj.action, np.float32)
    steps = 0
    for t in range(T):
        obs_n, rew_n, term_n, trunc_n = nat.step(actions[t])
        np.testing.assert_allclose(np.asarray(traj.next_obs[t]), obs_n,
                                   rtol=1e-5, atol=1e-5,
                                   err_msg=f"{name} next_obs at t={t}")
        np.testing.assert_allclose(np.asarray(traj.reward[t]), rew_n,
                                   rtol=1e-5, atol=1e-5,
                                   err_msg=f"{name} reward at t={t}")
        np.testing.assert_array_equal(np.asarray(traj.terminated[t]), term_n)
        steps += 1
        if bool(np.any(term_n | trunc_n)):
            break   # auto-reset draws differ between the engines from here
    assert steps >= 1


def test_rollout_logprob_consistency():
    _, _, ts, _, traj, _ = _rollout("pendulum", T=32)
    lp = policy_mod.log_prob(ts.policy_params, traj.obs, traj.action,
                             "relu", "jnp", False)
    np.testing.assert_allclose(np.asarray(lp), np.asarray(traj.log_prob),
                               rtol=1e-5, atol=1e-5)


def test_rollout_truncation_and_carry():
    """Window end force-truncated; the carry continues the episode step
    counters and the next window starts from the carried obs."""
    cfg, env, ts, _, traj, carry = _rollout("pendulum", T=32, seed=4)
    assert bool(jnp.all(traj.truncated[-1] | traj.terminated[-1]))
    state, obs_after = carry
    assert np.asarray(state.t).tolist() == [32] * 8  # horizon 200 > 32
    traj2, carry2 = jax.jit(lambda pp, k: ppo.rollout(
        cfg, env, pp, k, 8, 32, "jnp", env_carry=carry))(
        ts.policy_params, jax.random.PRNGKey(5))
    np.testing.assert_allclose(np.asarray(traj2.obs[0]),
                               np.asarray(obs_after), rtol=1e-6)
    assert np.asarray(carry2[0].t).tolist() == [64] * 8


def test_rollout_autoreset_at_horizon():
    """Rolling past the 200-step horizon truncates and resets counters."""
    _, _, _, _, traj, carry = _rollout("pendulum", n=4, T=210, seed=6)
    tr = np.asarray(traj.truncated)
    assert tr[199].all()          # genuine horizon truncation
    assert not tr[:199].any()
    assert (np.asarray(carry[0].t) == 10).all()  # reset, then 10 more steps


def test_gaussian_sampling_is_standard_normal():
    """eps = (a - mu) / sigma over many draws: mean ~0, std ~1, no lag-1
    correlation in time, and deterministic per key."""
    _, _, ts, _, traj, _ = _rollout("pendulum", n=64, T=200, seed=7)
    mu = policy_mod.gaussian_mean(ts.policy_params, traj.obs, "relu", "jnp")
    eps = np.asarray((traj.action - mu)
                     / jnp.exp(ts.policy_params["log_std"]))[..., 0]
    assert abs(eps.mean()) < 0.02, eps.mean()
    assert abs(eps.std() - 1.0) < 0.02, eps.std()
    ac = np.corrcoef(eps[:-1].ravel(), eps[1:].ravel())[0, 1]
    assert abs(ac) < 0.02, ac
    _, _, _, _, traj_b, _ = _rollout("pendulum", n=64, T=200, seed=7)
    np.testing.assert_array_equal(np.asarray(traj.action),
                                  np.asarray(traj_b.action))


def test_discrete_sampling_matches_softmax():
    """Categorical class frequencies track the softmax probabilities."""
    _, _, ts, _, traj, _ = _rollout("cartpole", n=64, T=200, seed=3)
    logits = policy_mod.mlp.apply(ts.policy_params["mlp"], traj.obs, "relu",
                                  "jnp")
    p = np.asarray(jax.nn.softmax(logits, axis=-1)).reshape(-1, 2)
    a = np.asarray(traj.action).reshape(-1)
    assert abs((a == 1).mean() - p[:, 1].mean()) < 0.02


@pytest.mark.parametrize("name,L", [("pendulum", 200), ("cartpole", 300),
                                    ("simple", 40)])
def test_evaluate_matches_metrics_of_its_rollout(name, L):
    """ppo.evaluate is the eval rollout (genuine done flags) followed by
    eval_metrics_from_traj: recomputing both by hand gives the same J, R
    and episode count."""
    cfg = PPOConfig(env=name, eval_envs=8, eval_len=L)
    env = envs.make(name)
    ts = ppo.init_train_state(cfg, env, jax.random.PRNGKey(0))
    key = jax.random.PRNGKey(9)
    m = jax.jit(lambda pp, k: ppo.evaluate(cfg, env, pp, k))(
        ts.policy_params, key)
    traj, _ = ppo.rollout(cfg, env, ts.policy_params, key, 8, L, "jnp",
                          force_truncate=False)
    ref = ppo.eval_metrics_from_traj(traj, env.spec.gamma)
    assert float(m.episodes) == float(ref.episodes)
    if float(ref.episodes) > 0:
        assert float(m.R) == pytest.approx(float(ref.R), rel=1e-5)
        assert float(m.J) == pytest.approx(float(ref.J), rel=1e-5)
