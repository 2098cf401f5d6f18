"""Flash-attention kernel (ops/flash_attn.py, Pallas on the Triton route) vs
the jnp twin, and the choice of attention core (models/attn).

Mirrors the reference's naive-kernel-beside-cuBLAS duality
(src/mat_mul.cu:83-120): models/attn._mha + causal_episode_mask is the
oracle; the flash kernel must reproduce its forward AND its gradients (the
custom VJP) to float tolerance, across ragged window lengths and head dims
(the wrapper's padding paths) and episode-mask patterns.  On the CPU the
kernel runs in the Pallas interpreter (``interpret=True``); the tests
marked ``gpu`` run the compiled kernel on the card (chip_smoke.py).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from ppoc_tpu.models import attn
from ppoc_tpu.ops import flash_attn

flash = functools.partial(flash_attn.flash_mha, interpret=True)


def _case(T, B, H, hd, p_done, seed=0):
    ks = jax.random.split(jax.random.PRNGKey(seed + T), 4)
    q = jax.random.normal(ks[0], (T, B, H, hd))
    k = jax.random.normal(ks[1], (T, B, H, hd))
    v = jax.random.normal(ks[2], (T, B, H, hd))
    done = jax.random.bernoulli(ks[3], p_done, (T, B))
    return q, k, v, done


def _engage_flash(monkeypatch, min_t=8):
    """Make the chooser pick the flash kernel here: a GPU platform, a
    CPU-testable threshold, and the kernel in the interpreter."""
    monkeypatch.setattr(attn, "_platform", lambda: "gpu")
    monkeypatch.setattr(attn, "FLASH_MIN_T", min_t)
    monkeypatch.setattr(flash_attn, "flash_mha", flash)


def _grads_match(T, B, H, hd, p_done, atol, seed=0, jit=False):
    q, k, v, done = _case(T, B, H, hd, p_done, seed=seed)
    ep = attn.episode_ids(done)
    mask = attn.causal_episode_mask(done)

    def loss_ref(q, k, v):
        return jnp.sum(jnp.sin(attn._mha(q, k, v, mask)))

    def loss_flash(q, k, v):
        return jnp.sum(jnp.sin(flash(q, k, v, ep)))

    gf = jax.grad(loss_flash, argnums=(0, 1, 2))
    gr = jax.grad(loss_ref, argnums=(0, 1, 2))(q, k, v)
    gf = (jax.jit(gf) if jit else gf)(q, k, v)
    for a, b in zip(gr, gf):
        np.testing.assert_allclose(np.asarray(b), np.asarray(a), atol=atol)


@pytest.mark.parametrize("T,B,H,hd,p_done", [
    (12, 3, 2, 8, 0.25),    # shorter than one block, heavy masking
    (50, 2, 1, 16, 0.1),    # odd length -> padded block
    (130, 2, 2, 8, 0.05),   # crosses block boundaries
    (256, 2, 2, 16, 0.3),   # exact blocks, many episodes
])
def test_forward_matches_jnp_twin(T, B, H, hd, p_done):
    q, k, v, done = _case(T, B, H, hd, p_done)
    ep = attn.episode_ids(done)
    mask = attn.causal_episode_mask(done)
    ref = attn._mha(q, k, v, mask)
    got = flash(q, k, v, ep)
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref), atol=1e-5)


@pytest.mark.parametrize("T,B,H,hd,p_done", [
    (12, 3, 2, 8, 0.25),
    (130, 2, 2, 8, 0.05),
])
def test_gradients_match_jnp_twin(T, B, H, hd, p_done):
    """The custom VJP (flash backward: per-block recomputation from the row
    logsumexp) against autodiff through the materialized-mask twin."""
    _grads_match(T, B, H, hd, p_done, atol=1e-4)


def test_apply_seq_backend_pallas_matches_jnp(monkeypatch):
    """The integration point: apply_seq with the flash kernel chosen equals
    the XLA path for outputs and parameter gradients."""
    T, E = 40, 4
    p = attn.init(jax.random.PRNGKey(0), 3, 16, 2, 2, 32, T, (16, 8, 2))
    xs = jax.random.normal(jax.random.PRNGKey(1), (T, E, 3))
    done = jax.random.bernoulli(jax.random.PRNGKey(2), 0.15, (T, E))

    def loss(p):
        return jnp.sum(jnp.square(
            attn.apply_seq(p, xs, done, "relu", backend="jnp")))

    out_j = attn.apply_seq(p, xs, done, "relu", backend="jnp")
    gj = jax.grad(loss)(p)
    _engage_flash(monkeypatch)
    assert attn.uses_flash(T, "jnp")
    out_f = attn.apply_seq(p, xs, done, "relu", backend="jnp")
    np.testing.assert_allclose(np.asarray(out_f), np.asarray(out_j),
                               atol=1e-5)
    gf = jax.grad(loss)(p)
    for a, b in zip(jax.tree.leaves(gj), jax.tree.leaves(gf)):
        np.testing.assert_allclose(np.asarray(b), np.asarray(a),
                                   rtol=1e-4, atol=1e-5)


def test_trainer_pallas_backend_learns_recall(monkeypatch):
    """End-to-end: an attention trainer whose parallel passes run the flash
    kernel trains exactly like the XLA-path trainer (which solves the
    recall differentiator, tests/test_attn.py): same metrics and weights
    to float noise after two epochs."""
    from ppoc_tpu import PPOConfig
    from ppoc_tpu.algo.trainer import Trainer

    cfg = PPOConfig(env="recall", n_envs=128, rollout_len=6,
                    minibatch_size=192, fits_per_epoch=2, eval_envs=256,
                    eval_len=6, hidden=(32,), seed=1, lr_policy=1e-3,
                    lr_v=1e-3, attn_dim=16, attn_layers=1, attn_heads=2)
    tr_x = Trainer(cfg)
    assert not attn.uses_flash(cfg.rollout_len, tr_x.backend)
    h_x = tr_x.train(n_epochs=2, log=False)
    _engage_flash(monkeypatch, min_t=4)
    tr_f = Trainer(cfg)
    assert attn.uses_flash(cfg.rollout_len, tr_f.backend)
    h_f = tr_f.train(n_epochs=2, log=False)
    for a, b in zip(h_x, h_f):
        assert b["value_loss"] == pytest.approx(a["value_loss"], rel=1e-4)
        assert b["policy_loss"] == pytest.approx(a["policy_loss"],
                                                 rel=1e-3, abs=1e-6)
        assert b["R"] == pytest.approx(a["R"], abs=1e-6)
    # Adam's normalized steps turn float-noise gradient differences on
    # near-zero gradients into lr-sized ones: compare leaves by norm
    for a, b in zip(jax.tree.leaves(tr_x.state.policy_params),
                    jax.tree.leaves(tr_f.state.policy_params)):
        a, b = np.asarray(a), np.asarray(b)
        assert np.linalg.norm(b - a) <= 1e-2 * np.linalg.norm(a)


def test_fully_masked_rows_are_finite():
    """Every query attends at least itself in real traces, but the padded
    window's rows must come back finite too (a NaN there would reach the
    real keys' gradients through the backward)."""
    T, B, H, hd = 9, 2, 1, 8   # pads to a 128-row block: 119 padded rows
    q, k, v, done = _case(T, B, H, hd, 0.5)
    ep = attn.episode_ids(done)
    out = flash(q, k, v, ep)
    assert np.isfinite(np.asarray(out)).all()
    g = jax.grad(lambda q: jnp.sum(flash(q, k, v, ep)))(q)
    assert np.isfinite(np.asarray(g)).all()


def test_bf16_compute_dtype_close_to_f32():
    """compute_dtype=bf16 carries q/k/v in bf16 with f32 softmax and
    accumulation: outputs and (f32) gradients track the f32 oracle at bf16
    rounding scale, and gradient dtypes stay f32."""
    T, B, H, hd = 130, 2, 2, 8
    q, k, v, done = _case(T, B, H, hd, 0.1)
    ep = attn.episode_ids(done)
    mask = attn.causal_episode_mask(done)
    ref = attn._mha(q, k, v, mask)
    got = flash(q, k, v, ep, compute_dtype=jnp.bfloat16)
    assert got.dtype == jnp.float32
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref), atol=0.05)

    gb = jax.grad(lambda q, k, v: jnp.sum(jnp.sin(
        flash(q, k, v, ep, compute_dtype=jnp.bfloat16))),
        argnums=(0, 1, 2))(q, k, v)
    gr = jax.grad(lambda q, k, v: jnp.sum(jnp.sin(attn._mha(q, k, v, mask))),
                  argnums=(0, 1, 2))(q, k, v)
    for a, b in zip(gr, gb):
        assert b.dtype == jnp.float32
        np.testing.assert_allclose(np.asarray(b), np.asarray(a), atol=0.1)


def test_apply_seq_bf16_backend_close_to_f32(monkeypatch):
    """backend='bf16' (XLA path, and the flash path once chosen) tracks the
    f32 outputs at bf16 rounding scale."""
    T, E = 40, 4
    p = attn.init(jax.random.PRNGKey(0), 3, 16, 2, 2, 32, T, (16, 8, 2))
    xs = jax.random.normal(jax.random.PRNGKey(1), (T, E, 3))
    done = jax.random.bernoulli(jax.random.PRNGKey(2), 0.15, (T, E))
    out_j = attn.apply_seq(p, xs, done, "relu", backend="jnp")
    out_b = attn.apply_seq(p, xs, done, "relu", backend="bf16")
    np.testing.assert_allclose(np.asarray(out_b), np.asarray(out_j),
                               atol=0.05)
    _engage_flash(monkeypatch)
    assert attn.uses_flash(T, "bf16")
    out_bf = attn.apply_seq(p, xs, done, "relu", backend="bf16")
    np.testing.assert_allclose(np.asarray(out_bf), np.asarray(out_j),
                               atol=0.05)


def test_bf16_sites_bisect_knob(monkeypatch):
    """BF16_SITES (the long-context precision bisect knob): the default is
    the full set; removing every site makes the bf16 backend reproduce the
    f32 forward EXACTLY; removing only 'scores' leaves the Q.K product in
    f32 (output changes vs full-bf16, still close to f32); with the flash
    kernel in play, a bisected attention site keeps the XLA core."""
    T, E = 40, 4
    p = attn.init(jax.random.PRNGKey(0), 3, 16, 2, 2, 32, T, (16, 8, 2))
    xs = jax.random.normal(jax.random.PRNGKey(1), (T, E, 3))
    done = jax.random.bernoulli(jax.random.PRNGKey(2), 0.15, (T, E))
    out_j = attn.apply_seq(p, xs, done, "relu", backend="jnp")
    out_b = attn.apply_seq(p, xs, done, "relu", backend="bf16")

    assert attn.BF16_SITES == frozenset(
        {"embed", "qkv", "scores", "av", "out", "ff", "head"})
    monkeypatch.setattr(attn, "BF16_SITES", frozenset())
    out_none = attn.apply_seq(p, xs, done, "relu", backend="bf16")
    np.testing.assert_array_equal(np.asarray(out_none), np.asarray(out_j))

    monkeypatch.setattr(attn, "BF16_SITES", attn.BF16_SITES | frozenset(
        {"embed", "qkv", "av", "out", "ff", "head"}))
    out_noscores = attn.apply_seq(p, xs, done, "relu", backend="bf16")
    assert not np.array_equal(np.asarray(out_noscores), np.asarray(out_b))
    np.testing.assert_allclose(np.asarray(out_noscores), np.asarray(out_j),
                               atol=0.05)
    # scores promoted -> the XLA core runs even where flash would engage
    # (the kernel carries one operand dtype for both products)
    _engage_flash(monkeypatch)
    assert not attn.uses_flash(T, "bf16")
    out_long = attn.apply_seq(p, xs, done, "relu", backend="bf16")
    np.testing.assert_allclose(np.asarray(out_long),
                               np.asarray(out_noscores), atol=1e-6)


@pytest.mark.parametrize("T,B,H,hd,p_done", [
    (1030, 1, 1, 8, 0.02),   # many blocks, ragged -> pads to 1152
    (2050, 1, 1, 8, 0.01),   # ragged -> pads to 2176
])
def test_forward_matches_jnp_twin_large_tiles(T, B, H, hd, p_done):
    """Long windows: the causal key-loop bound and the backward's start
    block are computed from the block sizes, so windows of many blocks,
    ragged past T, need their own exactness pins."""
    q, k, v, done = _case(T, B, H, hd, p_done)
    ep = attn.episode_ids(done)
    ref = attn._mha(q, k, v, attn.causal_episode_mask(done))
    got = flash(q, k, v, ep)
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref), atol=1e-5)


def test_gradients_match_jnp_twin_large_tiles():
    _grads_match(1030, 1, 1, 8, 0.02, atol=2e-4, seed=5, jit=True)


# --------------------------------------------------------------------------
# the wrapper's padding
# --------------------------------------------------------------------------

@pytest.mark.parametrize("T,hd,want", [
    (1, 8, (128, 16)),       # Triton dots need every width >= 16
    (128, 16, (128, 16)),    # already aligned
    (129, 16, (256, 16)),    # one step past a block
    (130, 24, (256, 32)),    # head dim up to the next power of two
    (2048, 64, (2048, 64)),  # d 512 / 8 heads: no padding
    (4096, 8, (4096, 16)),   # the curriculum width at T=4096
])
def test_padded_shape(T, hd, want):
    assert flash_attn.padded_shape(T, hd) == want


@pytest.mark.parametrize("hd", [4, 8, 12, 16, 24])
def test_head_dim_padding_is_exact(hd):
    """Zero-padded q/k columns leave the scores unchanged and the padded v
    columns are sliced off: any head dim, forward and gradients."""
    q, k, v, done = _case(20, 2, 2, hd, 0.1, seed=hd)
    ep = attn.episode_ids(done)
    mask = attn.causal_episode_mask(done)
    out = flash(q, k, v, ep)
    assert out.shape == q.shape
    np.testing.assert_allclose(np.asarray(out),
                               np.asarray(attn._mha(q, k, v, mask)),
                               atol=1e-5)
    gq = jax.grad(lambda q: jnp.sum(jnp.sin(flash(q, k, v, ep))))(q)
    gr = jax.grad(lambda q: jnp.sum(jnp.sin(attn._mha(q, k, v, mask))))(q)
    assert gq.shape == q.shape
    np.testing.assert_allclose(np.asarray(gq), np.asarray(gr), atol=1e-4)


@pytest.mark.parametrize("T", [1, 63, 64, 65, 129])
def test_window_padding_is_exact(T):
    """Padded keys lie after every real query (causality masks them) and
    padded queries are sliced off: any window length, with the gradients
    of k and v (which would see padded queries' leaks)."""
    q, k, v, done = _case(T, 2, 1, 8, 0.1, seed=7)
    ep = attn.episode_ids(done)
    mask = attn.causal_episode_mask(done)
    out = flash(q, k, v, ep)
    assert out.shape == (T, 2, 1, 8)
    np.testing.assert_allclose(np.asarray(out),
                               np.asarray(attn._mha(q, k, v, mask)),
                               atol=1e-5)
    gf = jax.grad(lambda k, v: jnp.sum(jnp.sin(flash(q, k, v, ep))),
                  argnums=(0, 1))(k, v)
    gr = jax.grad(lambda k, v: jnp.sum(jnp.sin(attn._mha(q, k, v, mask))),
                  argnums=(0, 1))(k, v)
    for a, b in zip(gr, gf):
        np.testing.assert_allclose(np.asarray(b), np.asarray(a), atol=1e-4)


def test_extra_batch_dims_fold():
    """[T, B1, B2, H, hd] inputs (two batch dims) fold into the kernel's
    batch and come back in their own shape."""
    q, k, v, done = _case(24, 6, 2, 8, 0.1)
    r = lambda x: x.reshape((24, 2, 3) + x.shape[2:])
    ep = attn.episode_ids(r(done))
    out = flash(r(q), r(k), r(v), ep)
    ref = flash(q, k, v, attn.episode_ids(done))
    assert out.shape == (24, 2, 3, 2, 8)
    np.testing.assert_allclose(np.asarray(out), np.asarray(r(ref)),
                               atol=1e-6)


# --------------------------------------------------------------------------
# the choice of attention core
# --------------------------------------------------------------------------

@pytest.mark.parametrize("platform,T,backend,want", [
    ("cpu", 1 << 14, "jnp", False),     # the CPU always runs XLA
    ("cpu", 1 << 14, "bf16", False),
    ("gpu", 1, "jnp", False),           # short windows run XLA
    ("gpu", None, "jnp", True),         # at the threshold: the kernel
    ("gpu", None, "bf16", True),
    ("gpu", 1 << 14, "jnp", True),
])
def test_uses_flash(monkeypatch, platform, T, backend, want):
    monkeypatch.setattr(attn, "_platform", lambda: platform)
    T = attn.FLASH_MIN_T if T is None else T
    assert attn.uses_flash(T, backend) is want


def test_uses_flash_below_threshold(monkeypatch):
    monkeypatch.setattr(attn, "_platform", lambda: "gpu")
    assert not attn.uses_flash(attn.FLASH_MIN_T - 1, "jnp")


def test_attention_core_on_cpu_is_xla():
    """On the CPU the chooser returns XLA's path at every length: the core
    equals _mha with the causal episode mask bit for bit."""
    q, k, v, done = _case(40, 2, 2, 8, 0.1)
    core = attn.attention_core(done, "jnp")
    np.testing.assert_array_equal(
        np.asarray(core(q, k, v)),
        np.asarray(attn._mha(q, k, v, attn.causal_episode_mask(done))))


# --------------------------------------------------------------------------
# on the card (chip_smoke.py runs these; they skip elsewhere)
# --------------------------------------------------------------------------

@pytest.mark.gpu
@pytest.mark.parametrize("T,B,H,hd", [
    (12, 3, 2, 8), (130, 2, 2, 8), (1030, 2, 4, 8), (512, 2, 8, 64),
])
def test_compiled_kernel_matches_jnp_twin(gpu, T, B, H, hd):
    q, k, v, done = _case(T, B, H, hd, 0.02)
    ep = attn.episode_ids(done)
    mask = attn.causal_episode_mask(done)
    with jax.default_matmul_precision("highest"):
        out = jax.jit(lambda q, k, v: flash_attn.flash_mha(q, k, v, ep))(
            q, k, v)
        ref = attn._mha(q, k, v, mask)
        gf = jax.jit(jax.grad(lambda q, k, v: jnp.sum(jnp.sin(
            flash_attn.flash_mha(q, k, v, ep))), argnums=(0, 1, 2)))(q, k, v)
        gr = jax.grad(lambda q, k, v: jnp.sum(jnp.sin(
            attn._mha(q, k, v, mask))), argnums=(0, 1, 2))(q, k, v)
    np.testing.assert_allclose(np.asarray(out), np.asarray(ref), atol=1e-5)
    for a, b in zip(gr, gf):
        np.testing.assert_allclose(np.asarray(b), np.asarray(a), atol=1e-4)


@pytest.mark.gpu
def test_chooser_picks_flash_on_gpu(gpu):
    assert attn.uses_flash(attn.FLASH_MIN_T, "jnp")
    assert not attn.uses_flash(attn.FLASH_MIN_T - 1, "jnp")


@pytest.mark.gpu
def test_apply_seq_flash_matches_xla_on_gpu(gpu, monkeypatch):
    T, E = 256, 4
    p = attn.init(jax.random.PRNGKey(0), 3, 32, 2, 4, 64, T, (32, 2))
    xs = jax.random.normal(jax.random.PRNGKey(1), (T, E, 3))
    done = jax.random.bernoulli(jax.random.PRNGKey(2), 0.02, (T, E))
    with jax.default_matmul_precision("highest"):
        monkeypatch.setattr(attn, "FLASH_MIN_T", 1 << 30)
        out_x = jax.jit(lambda p: attn.apply_seq(p, xs, done, "relu"))(p)
        monkeypatch.setattr(attn, "FLASH_MIN_T", 64)
        assert attn.uses_flash(T, "jnp")
        out_f = jax.jit(lambda p: attn.apply_seq(p, xs, done, "relu"))(p)
    np.testing.assert_allclose(np.asarray(out_f), np.asarray(out_x),
                               atol=1e-4)
