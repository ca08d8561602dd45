"""Quickstart: the paper's technique end to end in a few seconds;
counterpart of ``examples/quickstart.py``.

1. Build a sub-byte packed linear layer (W2A2, int16 lanes).
2. Validate the packed integer path against the float oracle.
3. Run the packed lattice dot on the port's kernel -- on the card the
   hand-written tensor-core K2 (``csrc/ulppack_matmul_mma.cu``), on the
   CPU its plain version -- and check exactness.
4. Show the overflow-free region (paper Fig. 5 boundary).

Run:  PYTHONPATH=src python -m repro_torch.examples.quickstart \\
          [--device cuda|cpu]
"""

import argparse

import numpy as np
import torch

from repro_torch.core import packing
from repro_torch.core.packing import PackSpec, overflow_free_region
from repro_torch.kernels import ops, ref
from repro_torch.kernels import plan as plan_lib
from repro_torch.kernels import ulppack_matmul


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    dev = plan_lib.resolve_device(args.device)
    rng = np.random.default_rng(0)

    # --- 1. a quantized linear: offline weight packing, runtime act packing
    spec = PackSpec(w_bits=2, a_bits=2, lane_dtype=torch.int16)
    print(f"packing spec: {spec}  (k_tile={spec.k_tile} packed lanes "
          "between extractions)")

    f32 = torch.float32
    x = torch.as_tensor(rng.normal(size=(4, 256)), dtype=f32, device=dev)
    w = torch.as_tensor(rng.normal(size=(256, 64)) * 0.1, dtype=f32,
                        device=dev)
    w_scale = torch.tensor(0.02, dtype=f32, device=dev)
    w_zp = torch.tensor(2, dtype=torch.int32, device=dev)
    a_scale = torch.tensor(0.08, dtype=f32, device=dev)
    a_zp = torch.tensor(2, dtype=torch.int32, device=dev)

    w_packed, col_sums = ops.prepare_weights(w, w_scale, w_zp, spec)
    print(f"weights: {tuple(w.shape)} f32 -> packed lanes "
          f"{tuple(w_packed.shape)} {spec.lane_name} "
          f"({w_packed.numel() * spec.lane_bytes} bytes vs "
          f"{w.numel() * 4})")

    y = ops.quantized_linear(x, w_packed, col_sums, a_scale, a_zp, w_scale,
                             w_zp, spec)
    y_ref = ref.quantized_linear_ref(x, w, a_scale, a_zp, w_scale, w_zp,
                                     spec.a_bits, spec.w_bits)
    err = float((y - y_ref).abs().max())
    print("packed vs float-oracle max err:", err)

    # --- 2. the packed lattice dot on the port's kernel -------------------
    q_a = torch.as_tensor(rng.integers(0, 4, (8, 200)), dtype=torch.int32,
                          device=dev)
    q_w = torch.as_tensor(rng.integers(0, 4, (200, 16)), dtype=torch.int32,
                          device=dev)
    a_p = packing.pack_activations(q_a, spec, -1)
    w_p = packing.pack_weights(q_w, spec, 0)
    before = ulppack_matmul.mma_launches["s32"]
    got = ops.packed_matmul(a_p, w_p, spec)
    launches = ulppack_matmul.mma_launches["s32"] - before
    want = ref.matmul_i32_ref(q_a, q_w)
    assert torch.equal(got, want), "kernel mismatch!"
    where = (f"tensor-core K2 on {dev}, {launches} launch"
             if dev.type == "cuda" else f"plain version on {dev}")
    print(f"ulppack_matmul ({where}): EXACT match with integer oracle")

    # --- 3. the overflow-free region (paper Fig. 5 / N+M<=7) --------------
    print("\noverflow-free k_tile table, int16 lanes (0 = unusable):")
    region = overflow_free_region(torch.int16, max_bits=4)
    print("      A=1  A=2  A=3  A=4")
    for wb in range(1, 5):
        row = [f"{region[(wb, ab)]:4d}" for ab in range(1, 5)]
        print(f"W={wb} " + " ".join(row))
    print("(reproduces the paper's N+M<=7 boundary: W4A4 is 0)")
    return {"max_err": err, "exact": True, "kernel_launches": launches,
            "region": region}


if __name__ == "__main__":
    main()
