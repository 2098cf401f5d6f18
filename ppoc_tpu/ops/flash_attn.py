"""Flash attention for the attention model family, on the GPU through
Pallas's Triton route.

The hot op of attention-trunk training is the causal episode-masked
multi-head attention inside ``models/attn.apply_seq``.  The XLA path
(``models/attn._mha``) materializes [T, T, B, H] mask, score and weight
planes in device memory: at the long-window curriculum's T=8192 with 32
envs and 4 heads one float32 plane is 34 GB, so past a few thousand steps
the XLA path cannot run at all.  This kernel computes the same attention
the flash way -- tiled over query blocks with the online-softmax
recurrence, score tiles living only in registers and shared memory -- and
a custom VJP recomputes the tiles in the backward from the forward's row
logsumexp, so whole update phases backpropagate through it.

Semantics are exactly ``_mha`` with ``causal_episode_mask``: query t attends
key s iff s <= t and both carry the same episode id.  Episode ids
(``models/attn.episode_ids``) are monotone in time, so this is causal
attention with segment ids.

The kernels are adapted from JAX's library kernel
``jax.experimental.pallas.ops.gpu.attention`` (``mha`` with
``causal=True`` and ``segment_ids``), changed in four ways:

  * every ``pallas_call`` names its route (``backend="triton"``);
  * they read the trunk's own [T, B, H, hd] layout (no transposes);
  * masked score lanes are zeroed explicitly, so a query block whose
    first key blocks all belong to earlier episodes never depends on
    underflow to cancel them;
  * the dots' precision is the process's matmul precision, exactly as for
    XLA's own dots: float32 operands run as TF32 on the tensor cores by
    default, and as IEEE float32 under
    ``jax.default_matmul_precision("highest")`` (which the references and
    the chip check use); bfloat16 operands (``compute_dtype``, the "bf16"
    backend) run on the tensor cores with float32 accumulation.

Shapes the wrapper fixes up: a Triton dot needs every dimension of its
right operand >= 16, so the head dim is zero-padded to at least 16 (zero
q/k columns leave the scores unchanged; the padded v columns are sliced
off).  The window is padded to the block size; padded keys lie after every
real query, so causality masks them, and padded queries are sliced off.

``interpret=True`` runs the kernels in the Pallas interpreter, which is how
the CPU tests exercise them; the model code never sets it.
"""
from __future__ import annotations

import functools
import math

import jax
import jax.numpy as jnp
from jax import lax
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

# large-negative score for masked lanes (finite, so max/exp2 stay NaN-free)
MASK = -0.7 * float(jnp.finfo(jnp.float32).max)
LOG2E = math.log2(math.e)

# Block sizes: of (64, 64, 32), (128, 64, 32) and (128, 128, 64), the
# fastest or within 3% of it for fwd+bwd at both the curriculum width
# (hd 8) and d 512 (hd 64), at every window from 512 to 8192 steps
# (bench_attn.py on an H100; PERF.md)
BLOCK_Q = 128      # forward query rows per program
BLOCK_K = 128      # forward keys per inner-loop step
BLOCK_BWD = 64     # backward query and key block
NUM_WARPS = 4
NUM_STAGES = 2


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def _valid(q_seg, q_pos, k_seg, k_pos):
    """[bq, bk] bool: key visible to query (same episode, not later)."""
    return ((q_seg[:, None] == k_seg[None, :])
            & (q_pos[:, None] >= k_pos[None, :]))


# --------------------------------------------------------------------------
# forward
# --------------------------------------------------------------------------

def _fwd_kernel(q_ref, k_ref, v_ref, seg_ref, o_ref, lse_ref, *,
                scale2: float, block_q: int, block_k: int):
    """One (query block, batch, head) program.  Refs: q/o [bq, hdp];
    k/v [Tp, hdp]; seg [Tp]; lse [bq] (base-2 logsumexp of the scaled
    scores, the residual the backward recomputes tiles from)."""
    i = pl.program_id(0)
    q = q_ref[...]
    q_pos = i * block_q + jnp.arange(block_q)
    q_seg = seg_ref[pl.ds(i * block_q, block_q)]

    def body(j, carry):
        acc, m, l = carry
        ks = pl.ds(j * block_k, block_k)
        k = k_ref[ks, :]
        s = pl.dot(q, k.T) * scale2        # [bq, bk]
        valid = _valid(q_seg, q_pos, seg_ref[ks],
                       j * block_k + jnp.arange(block_k))
        s = jnp.where(valid, s, MASK)
        m2 = jnp.maximum(m, jnp.max(s, axis=1))
        p = jnp.where(valid, jnp.exp2(s - m2[:, None]), 0.0)
        alpha = jnp.exp2(m - m2)
        l2 = l * alpha + jnp.sum(p, axis=1)
        v = v_ref[ks, :]
        acc2 = acc * alpha[:, None] + pl.dot(p.astype(v.dtype), v)
        return acc2, m2, l2

    hdp = q.shape[-1]
    acc0 = jnp.zeros((block_q, hdp), jnp.float32)
    m0 = jnp.full((block_q,), -jnp.inf, jnp.float32)
    l0 = jnp.zeros((block_q,), jnp.float32)
    # causal: only key blocks overlapping [0, (i + 1) * block_q)
    n_k = lax.div(block_q * (i + 1) + block_k - 1, block_k)
    acc, m, l = lax.fori_loop(0, n_k, body, (acc0, m0, l0))
    # every row attends at least itself, so l >= 1
    o_ref[...] = (acc / l[:, None]).astype(o_ref.dtype)
    lse_ref[...] = m + jnp.log2(l)


def _fwd(q, k, v, seg, scale: float, interpret: bool):
    Tp, B, H, hdp = q.shape
    grid = (Tp // BLOCK_Q, B, H)
    row_blk = pl.BlockSpec((BLOCK_Q, None, None, hdp),
                           lambda i, b, h: (i, b, h, 0))
    full = pl.BlockSpec((Tp, None, None, hdp), lambda i, b, h: (0, b, h, 0))
    return pl.pallas_call(
        functools.partial(_fwd_kernel, scale2=scale * LOG2E,
                          block_q=BLOCK_Q, block_k=BLOCK_K),
        grid=grid,
        in_specs=[row_blk, full, full,
                  pl.BlockSpec((Tp, None), lambda i, b, h: (0, b))],
        out_specs=[row_blk,
                   pl.BlockSpec((None, None, BLOCK_Q),
                                lambda i, b, h: (b, h, i))],
        out_shape=[jax.ShapeDtypeStruct(q.shape, q.dtype),
                   jax.ShapeDtypeStruct((B, H, Tp), jnp.float32)],
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=NUM_WARPS,
                                             num_stages=NUM_STAGES),
        interpret=interpret,
        name="flash_attn_fwd",
    )(q, k, v, seg)


# --------------------------------------------------------------------------
# backward
# --------------------------------------------------------------------------

def _bwd_kernel(q_ref, k_ref, v_ref, seg_ref, do_ref, lse_ref, delta_ref,
                dq_ref, dk_ref, dv_ref, *, scale: float, scale2: float,
                block: int):
    """One (batch, head, block) program: dk/dv of key block j (loop over
    the query blocks that may attend it), then dq of query block j (loop
    over the key blocks it may attend).  Refs: q/k/v/do [Tp, hdp];
    seg/lse/delta [Tp]; dq/dk/dv [block, hdp]."""
    j = pl.program_id(2)
    n_blocks = q_ref.shape[0] // block
    hdp = q_ref.shape[-1]
    js = pl.ds(j * block, block)
    pos_j = j * block + jnp.arange(block)
    seg_j = seg_ref[js]

    k = k_ref[js, :]
    v = v_ref[js, :]

    def dkv_body(i, carry):
        dk, dv = carry
        qs = pl.ds(i * block, block)
        q = q_ref[qs, :]
        do = do_ref[qs, :]
        s = pl.dot(q, k.T) * scale2          # [bq, bk]
        valid = _valid(seg_ref[qs], i * block + jnp.arange(block),
                       seg_j, pos_j)
        p = jnp.where(valid, jnp.exp2(s - lse_ref[qs][:, None]), 0.0)
        dv = dv + pl.dot(p.astype(do.dtype).T, do)
        dp = pl.dot(do, v.T) - delta_ref[qs][:, None]
        ds = p * dp * scale
        dk = dk + pl.dot(ds.astype(q.dtype).T, q)
        return dk, dv

    zeros = jnp.zeros((block, hdp), jnp.float32)
    dk, dv = lax.fori_loop(j, n_blocks, dkv_body, (zeros, zeros))
    dk_ref[...] = dk.astype(dk_ref.dtype)
    dv_ref[...] = dv.astype(dv_ref.dtype)

    q = q_ref[js, :]
    do = do_ref[js, :]
    lse = lse_ref[js]
    delta = delta_ref[js]

    def dq_body(i, dq):
        ks = pl.ds(i * block, block)
        kb = k_ref[ks, :]
        vb = v_ref[ks, :]
        s = pl.dot(q, kb.T) * scale2
        valid = _valid(seg_j, pos_j, seg_ref[ks],
                       i * block + jnp.arange(block))
        p = jnp.where(valid, jnp.exp2(s - lse[:, None]), 0.0)
        dp = pl.dot(do, vb.T) - delta[:, None]
        ds = p * dp * scale
        return dq + pl.dot(ds.astype(kb.dtype), kb)

    dq = lax.fori_loop(0, j + 1, dq_body, zeros)
    dq_ref[...] = dq.astype(dq_ref.dtype)


def _bwd(q, k, v, seg, out, lse, do, scale: float, interpret: bool):
    Tp, B, H, hdp = q.shape
    # rowsum(dO * O): the softmax-Jacobian term of every score gradient
    delta = jnp.sum(out.astype(jnp.float32) * do.astype(jnp.float32),
                    axis=-1).transpose(1, 2, 0)              # [B, H, Tp]
    full = pl.BlockSpec((Tp, None, None, hdp), lambda b, h, j: (0, b, h, 0))
    row = pl.BlockSpec((None, None, Tp), lambda b, h, j: (b, h, 0))
    blk = pl.BlockSpec((BLOCK_BWD, None, None, hdp),
                       lambda b, h, j: (j, b, h, 0))
    return pl.pallas_call(
        functools.partial(_bwd_kernel, scale=scale, scale2=scale * LOG2E,
                          block=BLOCK_BWD),
        grid=(B, H, Tp // BLOCK_BWD),
        in_specs=[full, full, full,
                  pl.BlockSpec((Tp, None), lambda b, h, j: (0, b)),
                  full, row, row],
        out_specs=[blk, blk, blk],
        out_shape=[jax.ShapeDtypeStruct(q.shape, q.dtype)] * 3,
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=NUM_WARPS,
                                             num_stages=NUM_STAGES),
        interpret=interpret,
        name="flash_attn_bwd",
    )(q, k, v, seg, do.astype(q.dtype), lse, delta)


@functools.partial(jax.custom_vjp, nondiff_argnums=(4, 5))
def _flash(q, k, v, seg, scale, interpret):
    return _fwd(q, k, v, seg, scale, interpret)[0]


def _flash_fwd(q, k, v, seg, scale, interpret):
    out, lse = _fwd(q, k, v, seg, scale, interpret)
    return out, (q, k, v, seg, out, lse)


def _flash_bwd(scale, interpret, res, do):
    q, k, v, seg, out, lse = res
    dq, dk, dv = _bwd(q, k, v, seg, out, lse, do, scale, interpret)
    return dq, dk, dv, None


_flash.defvjp(_flash_fwd, _flash_bwd)


# --------------------------------------------------------------------------
# public entry
# --------------------------------------------------------------------------

def padded_shape(T: int, hd: int):
    """(window, head dim) the kernel runs at: T up to a multiple of every
    block size, hd up to a power of two >= 16 (Triton's minimum dot
    width)."""
    blk = max(BLOCK_Q, BLOCK_K, BLOCK_BWD)
    return _round_up(T, blk), max(16, pl.next_power_of_2(hd))


def flash_mha(q: jax.Array, k: jax.Array, v: jax.Array, ep: jax.Array,
              compute_dtype=None, interpret: bool = False) -> jax.Array:
    """Causal episode-masked multi-head attention, flash-tiled.

    ``q``/``k``/``v``: [T, ..., H, hd] (any batch dims); ``ep``: [T, ...]
    int32 episode ids (models/attn.episode_ids).  Exactly ``_mha``'s
    semantics: query t attends key s iff s <= t and ep[s] == ep[t].
    Returns [T, ..., H, hd] in the input dtype.

    ``compute_dtype=jnp.bfloat16`` carries q/k/v (and the dots' operands)
    in bfloat16, while the softmax statistics and every accumulation stay
    float32; gradients come back in the input dtype.
    """
    T, H, hd = q.shape[0], q.shape[-2], q.shape[-1]
    batch = q.shape[1:-2]
    B = math.prod(batch)
    Tp, hdp = padded_shape(T, hd)

    def prep(x):
        x = x.reshape(T, B, H, hd)
        if compute_dtype is not None:
            x = x.astype(compute_dtype)
        return jnp.pad(x, ((0, Tp - T), (0, 0), (0, 0), (0, hdp - hd)))

    # padded steps get an episode id no real step has (ids are >= 0)
    seg = jnp.pad(ep.reshape(T, B).astype(jnp.int32), ((0, Tp - T), (0, 0)),
                  constant_values=-1)
    out = _flash(prep(q), prep(k), prep(v), seg, 1.0 / math.sqrt(hd),
                 interpret)
    return out[:T, :, :, :hd].reshape(q.shape).astype(q.dtype)
