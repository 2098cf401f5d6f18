"""Solve MountainCarContinuous with generic observation calibration.

The sparse-reward task fails with raw observations (position and velocity
scales differ ~26x, so the shared trunk wastes its early epochs learning
the scale).  Instead of the hand-derived `mountain_car_norm` wrapper, this
uses the framework's generic recipe: `envs.wrappers.calibrate` measures
per-dimension statistics with one jitted random-policy rollout and bakes
them into the config (`obs_loc`/`obs_scale`), which every consumer —
trainer, sweep lanes, serving — replays exactly.

Chip-measured: R = 90.2 at epoch 17, ~31 s wall
including per-epoch evals.  CLI equivalent:

    python -m ppoc_tpu --env mountain_car --calibrate --n-envs 512 \\
        --rollout-len 999 --minibatch-size 8192 --fits-per-epoch 1 \\
        --eval-envs 256 --eval-len 999 --ent-coeff 0.005 --stop-at-R 90

Usage: python examples/calibrated_mountain_car.py [n_epochs]
"""
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from ppoc_tpu import PPOConfig, Trainer
from ppoc_tpu.envs import wrappers
from ppoc_tpu.utils.cache import enable_compilation_cache


def main(argv):
    enable_compilation_cache()
    n_epochs = int(argv[1]) if len(argv) > 1 else 20

    base = PPOConfig(env="mountain_car", n_envs=512, rollout_len=999,
                     minibatch_size=8192, fits_per_epoch=1, eval_envs=256,
                     eval_len=999, ent_coeff=0.005, seed=0)
    t0 = time.time()
    cfg = wrappers.calibrate(base, n_envs=256, n_steps=999)
    print(f"calibrated in {time.time() - t0:.1f}s: "
          f"loc={tuple(round(x, 3) for x in cfg.obs_loc)} "
          f"scale={tuple(round(x, 3) for x in cfg.obs_scale)}")
    hist = Trainer(cfg).train(n_epochs=n_epochs, stop_at_R=90.0)
    print(f"final R {hist[-1]['R']:.1f} at epoch {hist[-1]['epoch']}")


if __name__ == "__main__":
    main(sys.argv)
