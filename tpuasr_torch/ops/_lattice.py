"""What the warp routes of the CTC and RNN-T lattices share on the Python
side (`ops/ctc.py:_ctc_plan`, `ops/rnnt_lattice.py:_rnnt_plan`), as
``csrc/lattice.cuh`` holds it on the CUDA side: the warp's shape, the values
a lane holds at most, the longest ring chunk and the shared memory a block
takes without opting in."""

WARP = 32  # lanes of a warp
MAX_K = 8  # values (states, columns) a lane holds on a warp route: 256 a warp
CHUNK = 32  # frames (CTC) or diagonals (RNN-T) a ring chunk holds at most
SMEM = 48 * 1024  # bytes of shared memory a block takes without opting in
