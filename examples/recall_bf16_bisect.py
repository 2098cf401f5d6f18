"""bf16 long-context bisect: WHICH tensor's rounding kills
recall_long's cue gradient under the bf16 backend?

The round-3/4 record: bf16 trains short-window memory identically but
NEVER lifts on the 512-step recall_long where f32 lifts at ~17 epochs.
This script trains the standard recipe with the bf16 backend while
promoting ONE attention GEMM site at a time back to f32
(models/attn.BF16_SITES): if removing a site restores learning, that
site's rounding is the killer.  Controls: all-bf16 (expected: stuck) and
all-f32 (the "jnp" backend, expected: solves).

Usage: python examples/recall_bf16_bisect.py [epochs] [seed]
Prints one line per leg; ~2-4 min each on the chip.
"""
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from ppoc_tpu import PPOConfig, Trainer
from ppoc_tpu.models import attn as attn_mod
from ppoc_tpu.utils.cache import enable_compilation_cache

ALL = ("embed", "qkv", "scores", "av", "out", "ff", "head")


def recipe(seed, backend):
    return PPOConfig(env="recall_long", rollout_len=512, eval_len=512,
                     n_envs=32, minibatch_size=4096, fits_per_epoch=2,
                     eval_envs=64, hidden=(32,), seed=seed,
                     lr_policy=1e-3, lr_v=1e-3, kernel_backend=backend,
                     attn_dim=32, attn_layers=2, attn_heads=4)


def leg(name, sites, backend, seed, n_epochs):
    attn_mod.BF16_SITES = frozenset(sites)
    tr = Trainer(recipe(seed, backend))
    t0 = time.time()
    best, curve = 0.0, []
    for ep in range(n_epochs):
        tr.train_epoch()
        if ep % 3 == 2 or ep == n_epochs - 1:
            r = tr.evaluate().R
            best = max(best, r)
            curve.append(round(r, 3))
    print(f"{name:28s} best R {best:.3f}  curve {curve}  "
          f"({time.time()-t0:.0f}s)", flush=True)
    return best


def main(argv):
    enable_compilation_cache()
    n_epochs = int(argv[1]) if len(argv) > 1 else 30
    seed = int(argv[2]) if len(argv) > 2 else 0
    try:
        leg("control f32 (jnp)", ALL, "jnp", seed, n_epochs)
        leg("control all-bf16", ALL, "bf16", seed, n_epochs)
        for drop in ALL:
            leg(f"bf16 minus {drop}", [s for s in ALL if s != drop],
                "bf16", seed, n_epochs)
    finally:
        attn_mod.BF16_SITES = frozenset(ALL)
    return 0


if __name__ == "__main__":
    raise SystemExit(main(sys.argv))
