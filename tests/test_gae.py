"""GAE associative scan vs the sequential reference recursion.

Mirrors the reference's implicit cross-check between its CUDA block scan
(src/ppo.cu:171-251) and CPU recursion (src/ppo.cu:326-369).
"""
import jax
import jax.numpy as jnp
import numpy as np

from ppoc_tpu.ops import gae as gae_ops


def _numpy_gae(r, v, vn, term, trunc, gamma, lam):
    """Literal transcription of the reference CPU loop (src/ppo.cu:338-353)."""
    T, E = r.shape
    adv = np.zeros((T + 1, E), np.float64)
    delta = r + gamma * vn * (~term) - v
    for t in range(T - 1, -1, -1):
        adv[t] = delta[t] + gamma * lam * (~(term[t] | trunc[t])) * adv[t + 1]
    return adv[:T]


def _random_problem(key, T=257, E=5):
    rng = np.random.RandomState(key)
    r = rng.randn(T, E).astype(np.float32)
    v = rng.randn(T, E).astype(np.float32)
    vn = rng.randn(T, E).astype(np.float32)
    term = rng.rand(T, E) < 0.05
    trunc = rng.rand(T, E) < 0.03
    return r, v, vn, term, trunc


def test_gae_matches_numpy_reference():
    r, v, vn, term, trunc = _random_problem(0)
    want = _numpy_gae(r, v, vn, term, trunc, 0.99, 0.95)
    adv, target = jax.jit(
        lambda *a: gae_ops.gae(*a, gamma=0.99, lam=0.95)
    )(r, v, vn, term, trunc)
    np.testing.assert_allclose(np.asarray(adv), want, rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(np.asarray(target), v + want, rtol=2e-4, atol=2e-4)


def test_gae_scan_matches_sequential_twin():
    r, v, vn, term, trunc = _random_problem(1, T=1000, E=3)
    a1, t1 = gae_ops.gae(r, v, vn, term, trunc, 0.99, 0.95)
    a2, t2 = gae_ops.gae_reference(r, v, vn, term, trunc, 0.99, 0.95)
    np.testing.assert_allclose(np.asarray(a1), np.asarray(a2), rtol=1e-4, atol=1e-4)


def test_gae_respects_termination_and_truncation():
    # one env, terminal at t=2: advantage at t=3.. must not leak into t<=2
    r = jnp.ones((6, 1))
    v = jnp.zeros((6, 1))
    vn = jnp.ones((6, 1)) * 10.0
    term = jnp.zeros((6, 1), bool).at[2, 0].set(True)
    trunc = jnp.zeros((6, 1), bool).at[5, 0].set(True)
    adv, _ = gae_ops.gae(r, v, vn, term, trunc, 0.99, 0.95)
    # at the terminal step delta = r (no bootstrap), and no accumulation from t=3
    assert abs(float(adv[2, 0]) - 1.0) < 1e-6
    # at a truncated step delta DOES bootstrap gamma*vn (reference delta uses
    # only terminated; src/ppo.cu:341) but accumulation stops
    assert abs(float(adv[5, 0]) - (1.0 + 0.99 * 10.0)) < 1e-5


def test_discounted_episode_returns():
    r = jnp.asarray([[1.0], [2.0], [3.0], [4.0]])
    done = jnp.asarray([[False], [True], [False], [True]])
    j = gae_ops.discounted_episode_returns(r, done, 0.5)
    # episode 1: steps 0-1 -> J0 = 1 + .5*2 = 2, J1 = 2
    # episode 2: steps 2-3 -> J2 = 3 + .5*4 = 5, J3 = 4
    np.testing.assert_allclose(np.asarray(j)[:, 0], [2.0, 2.0, 5.0, 4.0])


def test_normalize_matches_reference_eps():
    x = jnp.asarray([1.0, 2.0, 3.0])
    m, s = jnp.mean(x), jnp.std(x)
    y = gae_ops.normalize(x, m, s)
    np.testing.assert_allclose(
        np.asarray(y), (np.asarray(x) - float(m)) / (float(s) + 1e-8), rtol=1e-6
    )
