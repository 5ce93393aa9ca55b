"""PyTorch/CUDA port of tpuasr for NVIDIA Hopper (H100).

A second package beside the JAX reference ``tpuasr/``: it imports torch and
numpy and nothing of JAX or of ``tpuasr``. Entry points run on the card
unless the caller passes ``device="cpu"``; on the card the hand-written
kernels of ``tpuasr_torch/csrc`` run, on the CPU their plain PyTorch
versions.
"""
