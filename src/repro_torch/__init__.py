"""repro_torch: the Sparq serving stack ported to PyTorch and CUDA (Hopper).

A second package beside ``repro`` (the JAX reference, which it never
imports).  Subpackages mirror ``repro``'s names, so each port module names
its reference module.  Every kernel that ``repro`` writes in Pallas gets a
hand-written CUDA kernel here (``csrc/``), with a plain PyTorch version
beside it in the same ``kernels/`` module.
"""
