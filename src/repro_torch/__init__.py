"""PyTorch and CUDA port of the JAX package ``repro``.

The module layout and function names follow ``repro`` so that each function
has its counterpart there. Plain tensor code is PyTorch; each Pallas TPU
kernel of ``repro`` becomes a kernel written by hand for Hopper (sm_90a),
under ``repro_torch/kernels``.
"""
