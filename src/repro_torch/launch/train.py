"""End-to-end training launcher.

Runs the AsyncFlow GRPO post-training workflow (real rollout + real updates
through TransferQueue) on ``cuda`` unless ``--device cpu`` is given; by
default on the reduced architecture.

  PYTHONPATH=src python -m repro_torch.launch.train --device cpu \\
      --arch qwen2_5_7b --mode async --steps 4

``--checkpoint-dir`` and ``--resume`` are refused: durable run snapshots
are not ported yet (ROADMAP §1 item 9).
"""
from __future__ import annotations

import argparse
import json
import sys


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2_5_7b")
    ap.add_argument("--mode", default="async",
                    choices=["baseline", "streaming", "async"])
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--prompts-per-step", type=int, default=4)
    ap.add_argument("--group-size", type=int, default=4)
    ap.add_argument("--rollout-workers", type=int, default=2)
    ap.add_argument("--max-new-tokens", type=int, default=6)
    ap.add_argument("--staleness", type=int, default=1)
    ap.add_argument("--staggered", action="store_true",
                    help="sub-step async weight updates (Fig. 8d)")
    ap.add_argument("--chunk-tokens", type=int, default=0,
                    help="partial rollout chunk size (0 = off)")
    ap.add_argument("--policy", default="fifo",
                    choices=["fifo", "token_balance"])
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--checkpoint-dir", default="",
                    help="not ported yet (ROADMAP §1 item 9)")
    ap.add_argument("--checkpoint-interval", type=int, default=1)
    ap.add_argument("--resume", default=None,
                    help="not ported yet (ROADMAP §1 item 9)")
    ap.add_argument("--gantt", action="store_true")
    ap.add_argument("--out", default=None)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    if args.checkpoint_dir or args.resume:
        raise NotImplementedError(
            "--checkpoint-dir/--resume: durable run snapshots are not "
            "ported yet (ROADMAP §1 item 9)")

    from repro_torch.api import Trainer, TrainerConfig

    tcfg = TrainerConfig(
        arch=args.arch, mode=args.mode, num_steps=args.steps,
        prompts_per_step=args.prompts_per_step, group_size=args.group_size,
        rollout_workers=args.rollout_workers,
        max_new_tokens=args.max_new_tokens, staleness=args.staleness,
        staggered=args.staggered, policy=args.policy, lr=args.lr,
        seed=args.seed, chunk_tokens=args.chunk_tokens,
        checkpoint_interval_steps=args.checkpoint_interval,
        device=args.device)
    result = Trainer(tcfg).fit()

    summary = {
        "mode": args.mode, "arch": args.arch, "device": args.device,
        "wall_time_s": round(result.wall_time_s, 3),
        "throughput_samples_per_s": round(result.throughput, 2),
        "max_staleness": max(result.staleness_seen),
        "mean_reward_last": result.metrics[-1].get("mean_reward")
        if result.metrics else None,
        "bubble_fraction": {k: round(v, 3)
                            for k, v in result.bubble_fraction.items()},
    }
    print(json.dumps(summary, indent=1))
    if args.gantt:
        print(result.log.render_gantt())
    if args.out:
        with open(args.out, "w") as f:
            json.dump({**summary, "metrics": result.metrics}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
