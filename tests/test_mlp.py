"""models/mlp.apply (the XLA path every dense trunk runs) against a float64
NumPy reference: forward values and the gradients (dW, db, dx) XLA derives
by autodiff.

Mirrors the reference's practice of keeping naive kernels beside the cuBLAS
path as cross-checks (src/mat_mul.cu:83-120): the reference here is the
textbook forward and hand-written backward (src/neural_network.cu:121-231)
in float64.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from ppoc_tpu.models import mlp

ACT = {"relu": (lambda z: np.maximum(z, 0.0), lambda z: (z > 0).astype(z.dtype)),
       "tanh": (np.tanh, lambda z: 1.0 - np.tanh(z) ** 2)}


def _np_params(params):
    return [(np.asarray(w, np.float64), np.asarray(b, np.float64))
            for w, b in params]


def np_forward(params, x, activation):
    """Float64 forward; returns (out, pre-activations, layer inputs)."""
    f, _ = ACT[activation]
    h, zs, hs = np.asarray(x, np.float64), [], []
    for i, (w, b) in enumerate(params):
        hs.append(h)
        z = h @ w + b
        zs.append(z)
        h = f(z) if i < len(params) - 1 else z
    return h, zs, hs


def np_backward(params, x, activation, g_out):
    """Float64 backward of sum(out * g_out): per-layer (dW, db) and dx."""
    _, df = ACT[activation]
    _, zs, hs = np_forward(params, x, activation)
    grads = [None] * len(params)
    g = np.asarray(g_out, np.float64)
    for i in reversed(range(len(params))):
        if i < len(params) - 1:
            g = g * df(zs[i])
        w, _ = params[i]
        grads[i] = (hs[i].T @ g, g.sum(0))
        g = g @ w.T
    return grads, g


def _setup(sizes, batch, seed):
    params = mlp.init(jax.random.PRNGKey(seed), sizes)
    x = jax.random.normal(jax.random.PRNGKey(seed + 1), (batch, sizes[0]),
                          jnp.float32)
    return params, x


@pytest.mark.parametrize("sizes", [(3, 128, 128, 1), (3, 64, 64, 2),
                                   (17, 32, 5)])
@pytest.mark.parametrize("batch", [64, 100, 1024])
@pytest.mark.parametrize("activation", ["relu", "tanh"])
def test_forward_matches_float64_reference(sizes, batch, activation):
    params, x = _setup(sizes, batch, 0)
    with jax.default_matmul_precision("highest"):
        out = mlp.apply(params, x, activation, "jnp")
    ref, _, _ = np_forward(_np_params(params), x, activation)
    np.testing.assert_allclose(np.asarray(out), ref, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("sizes", [(3, 128, 128, 1), (5, 32, 32, 2)])
@pytest.mark.parametrize("batch", [64, 100])
@pytest.mark.parametrize("activation", ["relu", "tanh"])
def test_grads_match_float64_reference(sizes, batch, activation):
    params, x = _setup(sizes, batch, 2)
    g_out = np.asarray(jax.random.normal(jax.random.PRNGKey(9),
                                         (batch, sizes[-1])))

    def loss(p, x):
        return jnp.sum(mlp.apply(p, x, activation, "jnp") * g_out)

    with jax.default_matmul_precision("highest"):
        gp, gx = jax.grad(loss, argnums=(0, 1))(params, x)
    ref_p, ref_x = np_backward(_np_params(params), x, activation, g_out)
    for (dw, db), (rw, rb) in zip(gp, ref_p):
        np.testing.assert_allclose(np.asarray(dw), rw, rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(np.asarray(db), rb, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(np.asarray(gx), ref_x, rtol=1e-4, atol=1e-4)


def test_leading_dims_and_jit():
    """[T, E, d] inputs apply over the last axis; works under jit."""
    sizes = (3, 32, 32, 1)
    params, _ = _setup(sizes, 1, 4)
    x = jax.random.normal(jax.random.PRNGKey(5), (7, 13, 3), jnp.float32)
    with jax.default_matmul_precision("highest"):
        out = jax.jit(lambda p, x: mlp.apply(p, x, "relu"))(params, x)
    ref, _, _ = np_forward(_np_params(params), np.asarray(x).reshape(-1, 3),
                           "relu")
    assert out.shape == (7, 13, 1)
    np.testing.assert_allclose(np.asarray(out).reshape(-1, 1), ref,
                               rtol=1e-5, atol=1e-5)


def test_bf16_backend_tracks_float64_reference():
    """The bf16 backend (bfloat16 operands, f32 accumulation and master
    weights) stays within bf16 rounding of the float64 forward, and its
    gradients come back float32."""
    params, x = _setup((3, 64, 64, 2), 256, 6)
    out = mlp.apply(params, x, "relu", "bf16")
    ref, _, _ = np_forward(_np_params(params), x, "relu")
    assert out.dtype == jnp.float32
    np.testing.assert_allclose(np.asarray(out), ref, rtol=0.05, atol=0.05)
    g = jax.grad(lambda p: jnp.sum(mlp.apply(p, x, "relu", "bf16")))(params)
    assert all(leaf.dtype == jnp.float32 for leaf in jax.tree.leaves(g))
