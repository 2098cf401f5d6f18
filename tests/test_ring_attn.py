"""Ring attention over the sp (time-sharded) mesh axis (parallel/ring_attn).

The cross-device long-context axis: K/V blocks rotate around the ring via
ppermute while each device folds them into the flash online-softmax
statistics for its resident Q block.  The oracle is the single-device
materialized-mask attention (models/attn._mha + causal_episode_mask) —
the sharded result must match it globally, including episodes crossing
shard boundaries; global episode ids must match the unsharded cumsum.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh, PartitionSpec as P

from ppoc_tpu.models import attn
from ppoc_tpu.parallel import ring_attn


def _mesh(n):
    return Mesh(np.array(jax.devices()[:n]), ("sp",))


def _case(T, B, H, hd, p_done, seed=0):
    ks = jax.random.split(jax.random.PRNGKey(seed), 4)
    return (jax.random.normal(ks[0], (T, B, H, hd)),
            jax.random.normal(ks[1], (T, B, H, hd)),
            jax.random.normal(ks[2], (T, B, H, hd)),
            jax.random.bernoulli(ks[3], p_done, (T, B)))


@pytest.mark.parametrize("n_shards,p_done", [(2, 0.0), (4, 0.15), (8, 0.4)])
def test_matches_single_device(n_shards, p_done):
    T, B, H, hd = 32, 3, 2, 8
    q, k, v, done = _case(T, B, H, hd, p_done)
    ref = attn._mha(q, k, v, attn.causal_episode_mask(done))
    fn = jax.jit(jax.shard_map(
        functools.partial(ring_attn.ring_mha, axis_name="sp"),
        mesh=_mesh(n_shards),
        in_specs=(P("sp"),) * 4, out_specs=P("sp")))
    got = fn(q, k, v, done)
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref), atol=1e-5)


def test_episode_crossing_shard_boundary():
    """A lane whose episode ends exactly at a shard edge: the next shard's
    queries must not attend across it, and an episode spanning the edge
    must keep attending backwards."""
    T, B, H, hd, N = 16, 2, 1, 4, 4
    q, k, v, _ = _case(T, B, H, hd, 0.0, seed=1)
    done = jnp.zeros((T, B), bool)
    done = done.at[3, 0].set(True)   # lane 0: episode ends AT the edge
    done = done.at[5, 1].set(True)   # lane 1: ends mid-shard
    ref = attn._mha(q, k, v, attn.causal_episode_mask(done))
    fn = jax.jit(jax.shard_map(
        functools.partial(ring_attn.ring_mha, axis_name="sp"),
        mesh=_mesh(N), in_specs=(P("sp"),) * 4, out_specs=P("sp")))
    got = fn(q, k, v, done)
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref), atol=1e-5)


def test_global_episode_ids():
    T, B = 24, 3
    done = jax.random.bernoulli(jax.random.PRNGKey(7), 0.3, (T, B))
    ref = attn.episode_ids(done)
    fn = jax.jit(jax.shard_map(
        functools.partial(ring_attn.global_episode_ids, axis_name="sp"),
        mesh=_mesh(8), in_specs=(P("sp"),), out_specs=P("sp")))
    assert (np.asarray(fn(done)) == np.asarray(ref)).all()


def test_gradients_match_single_device():
    """BPTT through the ring (ppermute chain + online softmax) equals
    autodiff through the materialized mask."""
    T, B, H, hd, N = 16, 2, 2, 4, 4
    q, k, v, done = _case(T, B, H, hd, 0.2, seed=2)
    mask = attn.causal_episode_mask(done)

    def loss_ref(q, k, v):
        return jnp.sum(jnp.sin(attn._mha(q, k, v, mask)))

    ring = jax.shard_map(
        functools.partial(ring_attn.ring_mha, axis_name="sp"),
        mesh=_mesh(N), in_specs=(P("sp"),) * 4, out_specs=P("sp"))

    def loss_ring(q, k, v):
        return jnp.sum(jnp.sin(ring(q, k, v, done)))

    gr = jax.grad(loss_ref, argnums=(0, 1, 2))(q, k, v)
    gg = jax.jit(jax.grad(loss_ring, argnums=(0, 1, 2)))(q, k, v)
    for a, b in zip(gr, gg):
        np.testing.assert_allclose(np.asarray(b), np.asarray(a), atol=1e-4)
