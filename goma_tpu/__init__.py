"""goma_tpu — a JAX multiphysics finite-element framework for accelerators.

A ground-up JAX/XLA/Pallas re-design with the capabilities of Goma (Sandia's
full-Newton coupled multiphysics FEM code, see /root/reference): coupled
incompressible & viscoelastic fluid momentum, energy, species, ALE mesh motion,
level-set two-phase flow, porous media, shells, electrochemistry — assembled
with exact (AD) Jacobians and solved by damped full Newton.

Architecture (nothing is a translation of the C reference; the main path
runs on NVIDIA GPUs and, for tests, on the CPU):

- Meshes are reordered into same-element-type blocks; per-element residual
  kernels are pure functions, `vmap`-ed over all elements of a block, and
  differentiated with `jax.jacfwd` to produce exact local Jacobians
  (replacing ~200k LoC of hand-written derivatives in the reference's
  ``mm_fill_*.c``).
- Global assembly is gather + `segment_sum` into a CSR operator whose
  sparsity is precomputed on host (replacing MSR/Epetra scatter,
  reference ``src/mm_fill.c:4959 load_lec``).
- The linear solve is a JAX-native Krylov stack (restarted GMRES/BiCGStab
  with block-Jacobi/batched-LU preconditioning) instead of
  AztecOO/Amesos/PETSc (reference ``src/mm_sol_nonlinear.c:1290-1515``).
- Multi-device runs partition the dofs over a `jax.sharding.Mesh` with
  `ppermute` halo exchange and `psum` reductions (replacing MPI halo
  exchange in ``src/dp_comm.c``).
"""

__version__ = "0.1.0"

from goma_tpu import config as config
from goma_tpu.config import fp_dtype, set_fp_dtype
