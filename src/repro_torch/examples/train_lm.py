"""End-to-end run: QAT-train a ~100M-parameter LM for a few hundred steps
with the full substrate (data pipeline, AdamW + cosine, checkpointing, the
fault-tolerant loop); counterpart of ``examples/train_lm.py``.

The model is a scaled-down stablelm-family config (~100M params) trained
on the synthetic motif stream; loss drops visibly within a few hundred
steps.

Run:  PYTHONPATH=src python -m repro_torch.examples.train_lm \\
          [--steps 300] [--d-model N] [--device cuda|cpu]
"""

import argparse

from repro_torch import configs
from repro_torch.configs.base import ParallelConfig
from repro_torch.core.quant import QuantConfig
from repro_torch.data.pipeline import DataConfig
from repro_torch.train.loop import TrainLoopConfig, Trainer


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--d-model", type=int, default=512)
    ap.add_argument("--layers", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=256)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--no-qat", dest="qat", action="store_false")
    ap.add_argument("--ckpt-dir", default="train_lm_ckpt")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)

    cfg = configs.get_config("stablelm-1.6b").replace(
        num_layers=args.layers, d_model=args.d_model,
        num_heads=8, num_kv_heads=8, d_ff=args.d_model * 3,
        vocab_size=8192, param_dtype="float32", compute_dtype="float32",
        quant=QuantConfig(enabled=args.qat, w_bits=2, a_bits=2),
        parallel=ParallelConfig(remat="none", microbatches=1))
    n_params = cfg.param_counts()["total"]
    print(f"model: {cfg.num_layers}L d={cfg.d_model} "
          f"~{n_params/1e6:.0f}M params, QAT W2A2={cfg.quant.enabled}, "
          f"device {args.device}")

    data_cfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=args.seq_len,
                          global_batch=args.batch, seed=0)
    loop = TrainLoopConfig(total_steps=args.steps, checkpoint_every=100,
                           checkpoint_dir=args.ckpt_dir, log_every=10)
    trainer = Trainer(cfg, loop, data_cfg, seed=0, device=args.device,
                      train_step_kwargs={"peak_lr": 1e-3,
                                         "warmup_steps": 30,
                                         "total_steps": args.steps})
    trainer.install_preemption_handler()
    _, step = trainer.run()
    first = trainer.metrics_log[0]["loss"]
    last = trainer.metrics_log[-1]["loss"]
    print(f"\nloss: {first:.3f} -> {last:.3f} over {step} steps "
          f"({'improved' if last < first else 'NO IMPROVEMENT'})")
    return first, last


if __name__ == "__main__":
    main()
