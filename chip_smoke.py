"""Smoke test of the whole system on one GPU: kernel, training, serving.

    python chip_smoke.py             # one card: phases 0-5
    python chip_smoke.py --chips 4   # four cards: phase 6 only

Everything runs in this one process (a JAX process reserves most of the
card's memory, so a second one would fail).  Phases, in order; any failure
exits non-zero, and nothing is caught and carried on:

0. device: JAX's first device must be a GPU (else exit 1, no result).
1. kernel: the flash-attention kernel (ops/flash_attn.py) compiled for the
   card, fwd+bwd, at (T 4096, B 32, H 4, hd 8) and (T 2048, B 16, d 512,
   H 8), compared with XLA's attention (models/attn._mha) under float32
   ("highest") matmuls; then the tests marked ``gpu``, in-process.
2. train: one Pendulum fit (bench.bench_config) on the GPU against the
   same fit on the CPU, then ``Trainer.solve`` to R >= -200; checkpoint.
3. throughput shape: one reacher epoch (4096 envs x 150 steps, minibatch
   16384, 2x256 MLP); finite losses and peak device memory.
4. attention: the recall curriculum's T=4096 checkpoint
   (recall_curriculum_4096_s0.bin): the flash kernel must be chosen; one
   training epoch and one evaluation.
5. serve: serve.load_policy on phase 2's checkpoint answers a batch;
   serve.load_attention_policy on the T=4096 checkpoint decodes steps.
6. (--chips 4 only) the reacher fit data-parallel over four cards against
   the same global sizes on one card.

The last line of standard output is one JSON object:
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""
from __future__ import annotations

import argparse
import functools
import json
import math
import os
import shutil
import sys
import tempfile
import time

import jax
import jax.numpy as jnp
import numpy as np

from ppoc_tpu.utils import device

ROOT = os.path.dirname(os.path.abspath(__file__))
RECALL_CKPT = os.path.join(ROOT, "recall_curriculum_4096_s0.bin")


def log(*a):
    print(*a, flush=True)


def check(name, value, tol, ok):
    log(f"  {name}: {value!r} (tolerance {tol}) -> {'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit(f"chip_smoke: {name} outside its tolerance")


def phase(n, title):
    log(f"\n== phase {n}: {title}")
    return time.perf_counter()


def done(t0):
    log(f"  ({time.perf_counter() - t0:.1f} s)")


# --------------------------------------------------------------------------

def phase_device(n_chips):
    t0 = phase(0, "device")
    d = jax.devices()
    if d[0].platform != "gpu":
        print(f"chip_smoke: JAX found no GPU (first device: {d[0].platform})",
              file=sys.stderr)
        raise SystemExit(1)
    if len(d) < n_chips:
        raise SystemExit(f"chip_smoke: need {n_chips} GPUs, found {len(d)}")
    log(f"  device_kind: {d[0].device_kind}; devices: {len(d)}")
    log(f"  nvidia-smi: {device.card()}")
    from ppoc_tpu.utils.cache import enable_compilation_cache

    log(f"  compilation cache: {enable_compilation_cache()}")
    done(t0)
    return d


def phase_kernel():
    from ppoc_tpu.models import attn
    from ppoc_tpu.ops import flash_attn

    t0 = phase(1, "flash-attention kernel vs XLA attention")
    log("  kernel dots: float32 operands at the process's matmul precision "
        "(TF32 by default, IEEE float32 under 'highest', used here)")
    # float32 everywhere: the only differences left are summation order
    # and the online softmax's reassociation
    tol = 1e-4
    for T, B, H, hd in ((4096, 32, 4, 8), (2048, 16, 8, 64)):
        ks = jax.random.split(jax.random.PRNGKey(T + hd), 5)
        q, k, v, g = (jax.random.normal(kk, (T, B, H, hd)) for kk in ks[:4])
        done_ = jax.random.bernoulli(ks[4], 4.0 / T, (T, B))
        ep = attn.episode_ids(done_)

        def loss_flash(q, k, v):
            return jnp.sum(flash_attn.flash_mha(q, k, v, ep) * g)

        with jax.default_matmul_precision("highest"):
            fb = jax.jit(jax.value_and_grad(loss_flash, argnums=(0, 1, 2)))
            compiled = fb.lower(q, k, v).compile()
            log(f"  T={T} B={B} H={H} hd={hd}: compiled fwd+bwd "
                f"memory_analysis: {compiled.memory_analysis()}")
            out = jax.jit(lambda q, k, v: flash_attn.flash_mha(q, k, v, ep))(
                q, k, v)
            _, grads = compiled(q, k, v)
            # the reference at a batch XLA's [T, T, B, H] planes fit
            b = 4
            sl = lambda x: x[:, :b]
            mask = attn.causal_episode_mask(done_[:, :b])

            def loss_ref(q, k, v):
                return jnp.sum(attn._mha(q, k, v, mask) * g[:, :b])

            ref_out = jax.jit(lambda q, k, v: attn._mha(q, k, v, mask))(
                sl(q), sl(k), sl(v))
            _, ref_grads = jax.jit(jax.value_and_grad(
                loss_ref, argnums=(0, 1, 2)))(sl(q), sl(k), sl(v))
        for name, a, r in zip(("out", "dq", "dk", "dv"),
                              (out, *grads), (ref_out, *ref_grads)):
            a = np.asarray(sl(a))
            assert np.isfinite(a).all()
            check(f"T={T} hd={hd} max|{name} - ref|",
                  float(np.max(np.abs(a - np.asarray(r)))), tol,
                  float(np.max(np.abs(a - np.asarray(r)))) <= tol)
    done(t0)

    t0 = phase("1b", "tests marked gpu, in this process")
    import pytest

    os.environ["PPOC_TEST_PLATFORM"] = "gpu"
    rc = pytest.main(["-q", "-m", "gpu", "-p", "no:cacheprovider",
                      os.path.join(ROOT, "tests", "test_pallas_attn.py")])
    check("pytest -m gpu exit code", int(rc), 0, int(rc) == 0)
    done(t0)


def phase_train(tmp):
    from bench import SOLVE_R, bench_config

    from ppoc_tpu import envs
    from ppoc_tpu.algo import ppo
    from ppoc_tpu.algo.trainer import Trainer

    t0 = phase(2, "train: Pendulum bench config")
    cfg = bench_config(0)
    env = envs.make_for(cfg)
    fit = jax.jit(functools.partial(ppo.fit_step, cfg, env, backend="jnp"))
    key = jax.random.PRNGKey(1)
    cpu = jax.devices("cpu")[0]
    with jax.default_matmul_precision("highest"):
        ts = ppo.init_train_state(cfg, env, jax.random.PRNGKey(0))
        _, m_gpu = fit(ts, key)
        _, m_cpu = fit(jax.device_put(ts, cpu), jax.device_put(key, cpu))
    m_gpu, m_cpu = jax.device_get((m_gpu, m_cpu))
    log(f"  one fit, gpu: {m_gpu}")
    log(f"  one fit, cpu: {m_cpu}")
    # same program and PRNG stream on both; what differs is the order of
    # sums and the last bits of transcendental functions, which 200 env
    # steps and 700 sequential Adam steps carry forward
    for name, rel, ab in (("value_loss", 1e-2, 0.0),
                          ("policy_loss", 0.0, 1e-3),
                          ("entropy", 1e-3, 0.0),
                          ("mean_reward", 1e-3, 0.0)):
        a, b = float(getattr(m_gpu, name)), float(getattr(m_cpu, name))
        tol = ab + rel * abs(b)
        check(f"|{name} gpu - cpu|", abs(a - b), tol,
              math.isfinite(a) and abs(a - b) <= tol)

    tr = Trainer(cfg)
    t1 = time.perf_counter()
    res = tr.solve(target_R=SOLVE_R, max_epochs=60)
    log(f"  solve: {res} ({time.perf_counter() - t1:.1f} s incl. compile)")
    check("solve R", res["R"], f">= {SOLVE_R}", res["R"] >= SOLVE_R)
    path = os.path.join(tmp, "pendulum.bin")
    tr.save(path)
    log(f"  saved {path}")
    done(t0)
    return path


def reacher_cfg():
    from ppoc_tpu.config import PPOConfig

    return PPOConfig(env="reacher", n_envs=4096, rollout_len=150,
                     minibatch_size=16384, fits_per_epoch=1,
                     hidden=(256, 256), eval_envs=256, eval_len=150)


def phase_throughput():
    from ppoc_tpu.algo.trainer import Trainer

    t0 = phase(3, "throughput shape: reacher 4096 x 150, minibatch 16384")
    tr = Trainer(reacher_cfg())
    m = jax.device_get(tr.train_epoch())
    log(f"  epoch metrics: {m}")
    ok = all(math.isfinite(float(x)) for x in m)
    check("losses finite", ok, "all finite", ok)
    log(f"  peak_bytes_in_use: "
        f"{jax.devices()[0].memory_stats()['peak_bytes_in_use']}")
    done(t0)


def phase_attention():
    from ppoc_tpu.algo.trainer import Trainer
    from ppoc_tpu.models import attn

    t0 = phase(4, "attention: recall curriculum at T=4096")
    tr = Trainer.from_checkpoint(RECALL_CKPT)
    cfg = tr.cfg
    log(f"  {cfg.env}: T={cfg.rollout_len}, {cfg.n_envs} envs, attn_dim "
        f"{cfg.attn_dim}, {cfg.attn_heads} heads, backend {tr.backend}")
    picked = attn.uses_flash(cfg.rollout_len, tr.backend)
    check("flash kernel chosen", picked, True, picked)
    t1 = time.perf_counter()
    m = jax.device_get(tr.train_epoch())
    log(f"  epoch: {m} ({time.perf_counter() - t1:.1f} s incl. compile)")
    ok = all(math.isfinite(float(x)) for x in m)
    check("losses finite", ok, "all finite", ok)
    ev = tr.evaluate()
    log(f"  eval: {ev}")
    check("eval episodes", ev.episodes, "> 0", ev.episodes > 0)
    done(t0)


def phase_serve(pendulum_ckpt):
    from ppoc_tpu import serve

    t0 = phase(5, "serve")
    act = serve.load_policy(pendulum_ckpt)
    obs = jax.random.normal(jax.random.PRNGKey(3), (16, 3))
    a = np.asarray(act(obs))
    log(f"  load_policy: actions {a.shape}, first {a[:3].ravel()}")
    ok = a.shape == (16, 1) and np.isfinite(a).all()
    check("policy answers a batch", a.shape, "(16, 1), finite", ok)

    act = serve.load_attention_policy(RECALL_CKPT)
    cache = act.initial_state(4)
    obs_dim = act.spec.obs_dim
    actions = []
    for t in range(8):
        o = jax.random.normal(jax.random.PRNGKey(10 + t), (4, obs_dim))
        a, cache = act(o, cache)
        actions.append(np.asarray(a))
    a = np.stack(actions)
    log(f"  load_attention_policy: 8 steps x 4 lanes, actions {a.shape}, "
        f"cache t={int(cache['t'])}")
    ok = np.isfinite(a).all() and int(cache["t"]) == 8
    check("attention policy decodes", int(cache["t"]), 8, ok)
    done(t0)


def phase_mesh():
    from ppoc_tpu.algo.trainer import Trainer
    from ppoc_tpu.parallel import make_mesh

    t0 = phase(6, "reacher fit data-parallel over 4 cards vs one card")
    cfg = reacher_cfg()
    m4 = jax.device_get(Trainer(cfg, mesh=make_mesh(4)).train_epoch())
    m1 = jax.device_get(Trainer(cfg).train_epoch())
    log(f"  4 cards: {m4}")
    log(f"  1 card:  {m1}")
    # each shard draws its own env stream (the dp key folds the device
    # index), so the two runs see different rollouts of the same policy:
    # statistics of 614,400 transitions agree to sampling noise
    for name, rel, ab in (("value_loss", 5e-2, 0.0),
                          ("policy_loss", 0.0, 1e-2),
                          ("entropy", 1e-2, 0.0),
                          ("mean_reward", 5e-2, 0.0)):
        a, b = float(getattr(m4, name)), float(getattr(m1, name))
        tol = ab + rel * abs(b)
        check(f"|{name} 4 cards - 1 card|", abs(a - b), tol,
              math.isfinite(a) and abs(a - b) <= tol)
    done(t0)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--chips", type=int, default=1, choices=[1, 4],
                    help="4: run only the four-card data-parallel phase")
    args = ap.parse_args(argv)
    # phase 2 compares with the CPU: keep the CPU backend beside the GPU
    # where the environment names the platforms (the GPU stays first)
    plats = jax.config.jax_platforms or os.environ.get("JAX_PLATFORMS")
    if plats and "cpu" not in plats.split(","):
        jax.config.update("jax_platforms", plats + ",cpu")
    t_all = time.perf_counter()
    devs = phase_device(args.chips)
    if args.chips == 4:
        phase_mesh()
    else:
        tmp = tempfile.mkdtemp(prefix=".chip_smoke_", dir=ROOT)
        try:
            phase_kernel()
            ckpt = phase_train(tmp)
            phase_throughput()
            phase_attention()
            phase_serve(ckpt)
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
    log(f"\nall phases passed in {time.perf_counter() - t_all:.1f} s")
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs)}}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
