"""porousfreezethaw_tpu_torch — the PyTorch/CUDA port of porousfreezethaw_tpu.

A second package beside the JAX one, which stays the reference.  It runs
the intertrack freezing/thawing simulator and the spheres DEM with PyTorch
on one NVIDIA GPU (Hopper, ``sm_90a``): the f32 Merson solves of the
freezing model go through hand-written CUDA kernels (``csrc/``),
everything around them, and the DEM, is plain PyTorch and numpy.  It never
imports JAX.

Subpackages (each mirrors the JAX package's module of the same name)
-----------
core      grid geometry, device and dtype policy
config    Params configuration language (numpy-only copy)
models    freezing model: parameters, initial conditions, glass field,
          physics, the f64 right-hand side and the increment form; the
          DEM (models.dem): configuration, initial conditions, the dense
          pair forces, the final-positions writer
solvers   the adaptive Runge-Kutta-Merson controller (tensor, shard list or
          dict state), fixed-step RK4, Dormand-Prince 5(4)
ops.cuda  kernel wrappers with their plain PyTorch versions, and the build
parallel  the device mesh and the sharded freezing paths
io        NetCDF snapshots, checkpoint/resume, run logs, DEM CSV snapshots,
          the dataIO exporters (VTK, plain, gnuplot, PGM/PPM)
apps      the intertrack and spheres command-line applications
analysis  the observables: ice fraction, freezing-point statistic, eps_s
native    ctypes bindings of the repository's native IO library
convert   parameters and state carried across from the JAX package
"""

__version__ = "0.1.0"
