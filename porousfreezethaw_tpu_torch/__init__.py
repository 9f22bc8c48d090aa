"""porousfreezethaw_tpu_torch — the PyTorch/CUDA port of porousfreezethaw_tpu.

A second package beside the JAX one, which stays the reference.  It runs
the intertrack freezing/thawing simulator with PyTorch on one NVIDIA GPU
(Hopper, ``sm_90a``): the f32 increment-form Merson solve goes through two
hand-written CUDA kernels (``csrc/``), everything around them is plain
PyTorch and numpy.  It never imports JAX.

Subpackages (each mirrors the JAX package's module of the same name)
-----------
core      grid geometry, device and dtype policy
config    Params configuration language (numpy-only copy)
models    freezing model: parameters, initial conditions, glass field,
          physics, the f64 right-hand side and the increment form
solvers   the adaptive Runge-Kutta-Merson controller
ops.cuda  kernel wrappers with their plain PyTorch versions, and the build
io        NetCDF snapshots, checkpoint/resume, run logs
apps      the intertrack command-line application
convert   parameters and state carried across from the JAX package
"""

__version__ = "0.1.0"
