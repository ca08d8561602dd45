"""The paper's software flow on the port: QAT-train the sparq-cnn, then
deploy it through the packed conv2d path and compare accuracy float vs QAT
vs packed-integer (counterpart of ``examples/train_cnn_qat.py``).

Synthetic 10-class problem: each class is a fixed random 'template' image
plus noise (0.4 x a standard normal); W2A2 QAT should keep the network's
accuracy.  Templates, the training stream and the held-out set are drawn
on the device from ``torch.Generator``s seeded from ``--seed``; a fresh
batch each step.  The packed evaluation runs
``cnn.forward(quant_mode="packed")`` on prepared weights and layer plans:
the tensor-core K5 on the card, its plain version on the CPU.

Run:  PYTHONPATH=src python -m repro_torch.examples.train_cnn_qat \\
          [--steps 400] [--full] [--device cuda|cpu]
(reduced config at 24x24 by default, as the reference's example; --full
is the paper's 256x256x3, 7x7, channels 32/32/64 network.)
"""

from __future__ import annotations

import argparse
import statistics
import time

import torch
import torch.nn.functional as F

from repro_torch import configs
from repro_torch import tree as tree_lib
from repro_torch.kernels import plan as plan_lib
from repro_torch.models import cnn, common
from repro_torch.optim import adamw


def make_data(gen, templates, n):
    """``n`` labelled images: a random class's template plus noise."""
    ys = torch.randint(0, templates.shape[0], (n,), generator=gen,
                       device=templates.device)
    noise = torch.randn((n,) + tuple(templates.shape[1:]), generator=gen,
                        device=templates.device)
    return templates[ys] + 0.4 * noise, ys


def loss_fn(params, cfg, x, y, mode):
    logits = cnn.forward(params, cfg, x, quant_mode=mode)
    return -F.log_softmax(logits, dim=-1).gather(1, y[:, None]).mean()


def make_step(cfg, opt_cfg: adamw.AdamWConfig, lr: float):
    """One QAT step: ``step(params, opt, x, y) -> (params, opt, loss)``.
    The convolutions run in full f32 forward and backward (TF32 off), as
    the reference's float convolutions do."""
    def step(params, opt, x, y):
        leaves = [p.detach().requires_grad_(True)
                  for p in tree_lib.leaves(params)]
        with common.full_f32():
            loss = loss_fn(tree_lib.unflatten(params, leaves), cfg, x, y,
                           "qat")
            grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g
                 for g, p in zip(grads, leaves)]
        with torch.no_grad():
            upd, opt = adamw.update(tree_lib.unflatten(params, grads), opt,
                                    params, lr, opt_cfg)
            params = adamw.apply_updates(params, upd)
        return params, opt, loss.detach()

    return step


@torch.no_grad()
def accuracy(params, cfg, xs, ys, mode, batch, plans=None):
    hits = 0
    for i in range(0, xs.shape[0], batch):
        logits = cnn.forward(params, cfg, xs[i:i + batch], quant_mode=mode,
                             plans=plans)
        hits += int((logits.argmax(-1) == ys[i:i + batch]).sum())
    return hits / xs.shape[0]


def run(cfg, *, steps=400, batch=64, n_test=128, lr=1e-2, seed=0,
        device="cuda", log_every=25):
    """Train ``steps`` QAT steps; returns a report with the float, QAT and
    packed-integer accuracy on ``n_test`` held-out images, the losses, the
    host-clock ms of each step (each waits for its loss) and the trained
    and the packed params (with their layer plans)."""
    dev = plan_lib.resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    params = cnn.init_params(cfg, gen, device=dev)
    hw = cfg.cnn_input_hw
    templates = torch.randn((cfg.cnn_num_classes, hw, hw, 3), generator=gen,
                            device=dev)
    test_gen = torch.Generator(device=dev).manual_seed(seed + 1)
    xt, yt = make_data(test_gen, templates, n_test)
    opt_cfg = adamw.AdamWConfig(weight_decay=0.0)
    opt = adamw.init(params, opt_cfg)
    step = make_step(cfg, opt_cfg, lr)
    losses, ms = [], []
    for i in range(steps):
        x, y = make_data(gen, templates, batch)
        t0 = time.perf_counter()
        params, opt, loss = step(params, opt, x, y)
        losses.append(float(loss))
        ms.append((time.perf_counter() - t0) * 1e3)
        if log_every and i % log_every == 0:
            print(f"step {i:4d} qat-loss {losses[-1]:.4f}")
    packed = cnn.prepare_packed_params(params, cfg)
    plans = cnn.layer_plans(packed, cfg, (batch, hw, hw, 3))
    return {"acc_float": accuracy(params, cfg, xt, yt, "none", batch),
            "acc_qat": accuracy(params, cfg, xt, yt, "qat", batch),
            "acc_packed": accuracy(packed, cfg, xt, yt, "packed", batch,
                                   plans),
            "losses": losses, "step_ms": ms,
            "median_step_ms": statistics.median(ms), "params": params,
            "packed": packed, "plans": plans, "test": (xt, yt)}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=400)
    ap.add_argument("--full", action="store_true",
                    help="the full-width sparq-cnn at 256x256x3")
    ap.add_argument("--batch", type=int, default=None)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)

    if args.full:
        cfg, batch = configs.get_config("sparq-cnn"), args.batch or 8
    else:
        cfg = configs.get_config("sparq-cnn", reduced=True).replace(
            cnn_input_hw=24)
        batch = args.batch or 64
    rep = run(cfg, steps=args.steps, batch=batch, device=args.device)
    print(f"\naccuracy  float: {rep['acc_float']:.3f}   qat(W2A2): "
          f"{rep['acc_qat']:.3f}   packed-integer: {rep['acc_packed']:.3f}"
          f"   ({rep['median_step_ms']:.1f} ms a step)")
    print("(packed == deployed Sparq path: quantize+pack at runtime, "
          "packed conv2d, affine dequant)")
    return rep


if __name__ == "__main__":
    main()
