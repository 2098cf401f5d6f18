"""Adam, losses, policy math vs literal reference formulas."""
import math

import jax
import jax.numpy as jnp
import numpy as np

from ppoc_tpu.models import mlp, policy
from ppoc_tpu.ops import adam, losses


# --- Adam -------------------------------------------------------------------

def _reference_adam_step(p, g, m, v, t, lr, b1=0.9, b2=0.999):
    """Transcription of src/adam.cu:53-74."""
    t = t + 1
    bc1 = 1 - b1 ** t
    bc2 = 1 - b2 ** t
    step_size = lr / bc1
    m = b1 * m + (1 - b1) * g
    v = b2 * v + (1 - b2) * g ** 2
    denom = np.sqrt(v / bc2) + 1e-8
    return p - step_size * m / denom, m, v, t


def test_adam_matches_reference_formula():
    rng = np.random.RandomState(0)
    p = rng.randn(7, 3).astype(np.float32)
    params = {"w": jnp.asarray(p)}
    state = adam.init(params)
    m = np.zeros_like(p)
    v = np.zeros_like(p)
    t = 0
    pp = p.copy()
    for i in range(5):
        g = rng.randn(7, 3).astype(np.float32)
        params, state = adam.update(params, {"w": jnp.asarray(g)}, state, lr=3e-4)
        pp, m, v, t = _reference_adam_step(pp, g, m, v, t, lr=3e-4)
    np.testing.assert_allclose(np.asarray(params["w"]), pp, rtol=1e-5, atol=1e-7)
    assert int(state.t) == 5


def test_adam_separate_states_independent_timesteps():
    """Three Adams like create_ppo (src/ppo.cu:19-25): timesteps independent."""
    a = adam.init(jnp.zeros(3))
    b = adam.init(jnp.zeros(2))
    _, a = adam.update(jnp.zeros(3), jnp.ones(3), a, 1e-3)
    assert int(a.t) == 1 and int(b.t) == 0


# --- clipped surrogate -------------------------------------------------------

def _reference_policy_grad(logp, logp_old, adv, eps, m):
    """Transcription of policy_loss_and_grad (src/ppo.cu:89-100): gradient of
    the loss w.r.t. each logprob."""
    ratio = np.exp(logp - logp_old)
    adv_pos = adv > 0
    ratio_pos = ratio > 1 + eps
    ratio_neg = ratio < 1 - eps
    mask = (adv_pos & ~ratio_pos) | (~adv_pos & ~ratio_neg)
    grad = -mask.astype(np.float32) * adv * ratio / m
    loss = -np.mean(
        adv * (adv_pos * (ratio_pos * (1 + eps) + ~ratio_pos * ratio)
               + ~adv_pos * (ratio_neg * (1 - eps) + ~ratio_neg * ratio))
    )
    return loss, grad


def test_clipped_surrogate_value_and_grad_match_reference():
    rng = np.random.RandomState(1)
    m = 256
    logp = rng.randn(m).astype(np.float32) * 0.3
    logp_old = logp + rng.randn(m).astype(np.float32) * 0.3
    adv = rng.randn(m).astype(np.float32)
    want_loss, want_grad = _reference_policy_grad(logp, logp_old, adv, 0.2, m)

    f = lambda lp: losses.clipped_surrogate_loss(lp, jnp.asarray(logp_old), jnp.asarray(adv), 0.2)
    got_loss, got_grad = jax.value_and_grad(f)(jnp.asarray(logp))
    np.testing.assert_allclose(float(got_loss), want_loss, rtol=1e-5)
    np.testing.assert_allclose(np.asarray(got_grad), want_grad, rtol=1e-4, atol=1e-7)


def test_value_loss_matches_reference_mse():
    rng = np.random.RandomState(2)
    y = rng.randn(64).astype(np.float32)
    t = rng.randn(64).astype(np.float32)
    # src/loss.cu:5-13: sum of squares / (m*n); grad 2*(y-t)/(m*n)
    np.testing.assert_allclose(
        float(losses.value_loss(jnp.asarray(y), jnp.asarray(t))),
        np.mean((y - t) ** 2), rtol=1e-6,
    )
    g = jax.grad(lambda yy: losses.value_loss(yy, jnp.asarray(t)))(jnp.asarray(y))
    np.testing.assert_allclose(np.asarray(g), 2 * (y - t) / 64, rtol=1e-5)


# --- Gaussian policy ----------------------------------------------------------

def test_gaussian_log_prob_matches_reference_formula():
    """_compute_log_prob (src/policy.cu:67-74)."""
    rng = np.random.RandomState(3)
    k = 4
    mu = rng.randn(k).astype(np.float32)
    log_std = rng.randn(k).astype(np.float32) * 0.3
    a = rng.randn(k).astype(np.float32)
    want = -0.5 * k * math.log(2 * math.pi) - np.sum(
        log_std + 0.5 * ((a - mu) / np.exp(log_std)) ** 2
    )
    got = policy.gaussian_log_prob_from_mean(
        jnp.asarray(mu)[None], jnp.asarray(log_std), jnp.asarray(a)[None]
    )
    np.testing.assert_allclose(float(got[0]), want, rtol=1e-5)


def test_gaussian_entropy_matches_reference():
    """compute_entropy (src/policy.cu:171-178)."""
    log_std = jnp.asarray([0.1, -0.2, 0.3])
    want = 3 * 0.5 * (1 + math.log(2 * math.pi)) + (0.1 - 0.2 + 0.3)
    got = policy.gaussian_entropy({"log_std": log_std})
    np.testing.assert_allclose(float(got), want, rtol=1e-6)


def test_gaussian_sample_statistics():
    key = jax.random.PRNGKey(0)
    params = policy.init_gaussian(key, 3, 2, (16,), init_std=0.5)
    obs = jnp.zeros((20000, 3))
    a, logp = policy.gaussian_sample(params, obs, key, "relu", "jnp")
    mu = policy.gaussian_mean(params, obs, "relu", "jnp")
    np.testing.assert_allclose(np.asarray(a).std(0), 0.5, atol=0.02)
    np.testing.assert_allclose(np.asarray(a).mean(0), np.asarray(mu)[0], atol=0.02)
    # log-prob consistency with the standalone function
    lp2 = policy.gaussian_log_prob(params, obs, a, "relu", "jnp")
    np.testing.assert_allclose(np.asarray(logp), np.asarray(lp2), rtol=1e-4, atol=1e-5)


def test_categorical_policy_consistency():
    key = jax.random.PRNGKey(1)
    params = policy.init_categorical(key, 4, 3, (16,))
    obs = jax.random.normal(key, (512, 4))
    a, logp = policy.categorical_sample(params, obs, key, "relu", "jnp")
    assert a.shape == (512, 1) and a.dtype == jnp.int32
    lp2 = policy.categorical_log_prob(params, obs, a, "relu", "jnp")
    np.testing.assert_allclose(np.asarray(logp), np.asarray(lp2), rtol=1e-5)
    ent = policy.categorical_entropy(params, obs, "relu", "jnp")
    assert 0.0 < float(ent) <= math.log(3) + 1e-5


# --- MLP init ------------------------------------------------------------------

def test_mlp_init_reference_bounds():
    """Init scheme of src/neural_network.cu:40-51: uniform with the derived
    bounds, hidden gain sqrt(2), output gain 1."""
    key = jax.random.PRNGKey(42)
    params = mlp.init(key, (3, 128, 128, 1))
    for i, (w, b) in enumerate(params):
        fan_in, fan_out = w.shape
        gain = 1.0 if i == 2 else math.sqrt(2.0)
        bound = math.sqrt(3.0) * gain * math.sqrt(2.0 / (fan_in + fan_out))
        wa = np.asarray(w)
        assert wa.max() <= bound and wa.min() >= -bound
        # uniform(-b, b) has std b/sqrt(3)
        np.testing.assert_allclose(wa.std(), bound / math.sqrt(3), rtol=0.15)
        ba = np.asarray(b)
        assert np.abs(ba).max() <= 1.0 / math.sqrt(fan_in)


def test_mlp_forward_shapes_and_linearity():
    key = jax.random.PRNGKey(0)
    params = mlp.init(key, (3, 8, 8, 2))
    x = jax.random.normal(key, (5, 7, 3))
    y = mlp.apply(params, x, "relu", "jnp")
    assert y.shape == (5, 7, 2)
    # "none" activation composes to an affine map
    p1 = [(jnp.eye(3), jnp.zeros(3)), (jnp.eye(3) * 2, jnp.ones(3))]
    y2 = mlp.apply(p1, jnp.ones((1, 3)), "none", "jnp")
    np.testing.assert_allclose(np.asarray(y2), np.full((1, 3), 3.0))


def test_bf16_backend_forward_and_training():
    """kernel_backend='bf16': forward matches f32 within bf16 tolerance and
    training still learns (master weights stay f32; chip runs show identical
    solve-epoch counts)."""
    import numpy as np

    from ppoc_tpu import PPOConfig, Trainer
    from ppoc_tpu.models import mlp

    params = mlp.init(jax.random.PRNGKey(0), (5, 64, 64, 2))
    x = jax.random.normal(jax.random.PRNGKey(1), (32, 5), jnp.float32)
    out16 = mlp.apply(params, x, "relu", "bf16")
    out32 = mlp.apply(params, x, "relu", "jnp")
    assert out16.dtype == jnp.float32  # f32 accumulation/out
    np.testing.assert_allclose(np.asarray(out16), np.asarray(out32),
                               rtol=2e-2, atol=2e-2)

    cfg = PPOConfig(env="simple", n_envs=32, rollout_len=15, minibatch_size=64,
                    fits_per_epoch=5, n_epochs=3, eval_envs=64, eval_len=15,
                    kernel_backend="bf16", hidden=(32, 32), seed=0)
    hist = Trainer(cfg).train(log=False)
    assert hist[-1]["R"] > 0.5
