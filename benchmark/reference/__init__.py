"""The plain references, the benchmark's inputs and its trace arithmetic.

Plain PyTorch and NumPy only: nothing here imports the program under test
(`tpuasr_torch`), the JAX package or JAX.
"""
