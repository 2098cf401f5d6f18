"""Flash attention kernel vs XLA attention, forward + backward, on the GPU.

Times one jitted value-and-gradient of causal episode-masked attention
through the flash kernel (ops/flash_attn.py, float32 and bfloat16
operands) and through XLA's materialized-mask path (models/attn._mha with
causal_episode_mask built in the same program, as training does), at the
attention trunks' real widths:

  * ``curriculum``: 32 envs, 4 heads, head dim 8 (attn_dim 32, the recall
    curriculum of examples/recall_xl_curriculum.py);
  * ``d512``: 16 envs, 8 heads, head dim 64 (attn_dim 512).

XLA runs out of device memory at long windows; such a cell reports the
error instead of a time.  These numbers set models/attn.FLASH_MIN_T.

Usage:  python bench_attn.py [--T 512,1024,2048,4096,8192] [--check]
``--check`` compiles fwd+bwd once per width at T=4096 and compares with
the reference under float32 ("highest") matmuls, then stops.  Otherwise
all float32 dots run at JAX's default matmul precision (TF32 on the card).
Prints one JSON line per cell; every line names its device.
"""
from __future__ import annotations

import argparse
import json
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np

from ppoc_tpu.models import attn
from ppoc_tpu.ops import flash_attn
from ppoc_tpu.utils import device
from ppoc_tpu.utils.cache import enable_compilation_cache

WIDTHS = {"curriculum": (32, 4, 8), "d512": (16, 8, 64)}


def inputs(T, B, H, hd, seed=0):
    ks = jax.random.split(jax.random.PRNGKey(seed), 5)
    q, k, v, g = (jax.random.normal(kk, (T, B, H, hd)) for kk in ks[:4])
    # long episodes, as the recall envs run them
    done = jax.random.bernoulli(ks[4], 2.0 / T, (T, B))
    return q, k, v, g, done


def flash_core(dtype):
    def core(q, k, v, done):
        return flash_attn.flash_mha(q, k, v, attn.episode_ids(done),
                                    compute_dtype=dtype)
    return core


def xla_core(q, k, v, done):
    return attn._mha(q, k, v, attn.causal_episode_mask(done))


def fwd_bwd(core):
    def f(q, k, v, g, done):
        return jax.value_and_grad(
            lambda q, k, v: jnp.sum(core(q, k, v, done) * g),
            argnums=(0, 1, 2))(q, k, v)
    return jax.jit(f)


def time_ms(fn, args, reps=5):
    jax.block_until_ready(fn(*args))      # compile + first run
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        ts.append(time.perf_counter() - t0)
    return 1e3 * float(np.median(ts))


def check(rec):
    """fwd+bwd at T=4096 per width vs the reference at "highest"."""
    ok = True
    for name, (B, H, hd) in WIDTHS.items():
        T = 4096
        B_ref = 4   # small enough for XLA's [T, T, B, H] planes
        q, k, v, g, done = (x[:, :B_ref] for x in inputs(T, B, H, hd))
        with jax.default_matmul_precision("highest"):
            _, g_ref = fwd_bwd(xla_core)(q, k, v, g, done)
            o_ref = jax.jit(xla_core)(q, k, v, done)
        o = jax.jit(flash_core(None))(q, k, v, done)
        _, gr = fwd_bwd(flash_core(None))(q, k, v, g, done)
        errs = [float(jnp.max(jnp.abs(a - b)))
                for a, b in zip((o, *gr), (o_ref, *g_ref))]
        tol = 1e-4
        ok &= max(errs) <= tol
        print(json.dumps({"check": name, "T": T, "B": B_ref, "H": H,
                          "hd": hd, "max_abs_err_out_dq_dk_dv": errs,
                          "tol": tol, **rec}), flush=True)
    return ok


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--T", default="512,1024,2048,4096,8192")
    ap.add_argument("--check", action="store_true")
    args = ap.parse_args(argv)
    enable_compilation_cache()
    rec = device.require_gpu()
    log = lambda *a: print(*a, file=sys.stderr, flush=True)
    if args.check:
        return 0 if check(rec) else 1
    variants = {"flash_f32": fwd_bwd(flash_core(None)),
                "flash_bf16": fwd_bwd(flash_core(jnp.bfloat16)),
                "xla_f32": fwd_bwd(xla_core)}
    for name, (B, H, hd) in WIDTHS.items():
        for T in (int(t) for t in args.T.split(",")):
            row = {"width": name, "T": T, "B": B, "H": H, "hd": hd}
            x = inputs(T, B, H, hd)
            for vname in ("flash_f32", "flash_bf16"):
                row[vname + "_ms"] = time_ms(variants[vname], x)
            try:
                row["xla_f32_ms"] = time_ms(variants["xla_f32"], x)
            except jax.errors.JaxRuntimeError as e:  # XLA's planes outgrow
                # the card (out of memory, or autotuning cannot allocate)
                row["xla_f32_ms"] = None
                row["xla_f32_error"] = str(e).splitlines()[0][:200]
            log(row)
            print(json.dumps({**row, **rec}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
