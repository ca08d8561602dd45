"""CLI trainer: --arch <id> [--reduced] with the fault-tolerant loop
(counterpart of ``repro/launch/train.py``).

    PYTHONPATH=src python -m repro_torch.launch.train --arch stablelm-1.6b \\
        --reduced --steps 100 --ckpt-dir ckpt --device cpu

The full configs run on one card (``--device cuda``, the default); the
reduced ones exercise the same code path on the CPU.
"""

from __future__ import annotations

import argparse

from repro_torch import configs
from repro_torch.data.pipeline import DataConfig
from repro_torch.train.loop import TrainLoopConfig, Trainer


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=configs.ALL_NAMES)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--ckpt-dir", default="checkpoints")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--schedule", default=None,
                    help="cosine|wsd (default: wsd for minicpm, else cosine)")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)

    cfg = configs.get_config(args.arch, reduced=args.reduced)
    if cfg.family == "cnn":
        raise SystemExit("use python -m repro_torch.examples.train_cnn_qat "
                         "for sparq-cnn")
    schedule = args.schedule or (
        "wsd" if args.arch == "minicpm-2b" else "cosine")
    data_cfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=args.seq_len,
                          global_batch=args.batch)
    loop = TrainLoopConfig(total_steps=args.steps,
                           checkpoint_every=args.ckpt_every,
                           checkpoint_dir=args.ckpt_dir)
    trainer = Trainer(cfg, loop, data_cfg, device=args.device,
                      train_step_kwargs={"peak_lr": args.lr,
                                         "schedule": schedule,
                                         "total_steps": args.steps})
    trainer.install_preemption_handler()
    return trainer.run()


if __name__ == "__main__":
    main()
