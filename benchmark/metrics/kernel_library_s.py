"""kernel_library_s: the seconds the process spent on the kernel library
(the program's ``pft.kernels.load`` spans: the sources' hash, the nvcc
build where the library was missing or stale, and the load of
``libpft_kernels.so``).  None where the program records no such span."""


def read(rec, peaks):
    try:
        from porousfreezethaw_tpu_torch.core import tracing
    except ImportError:
        return None
    loads = [s.seconds for s in tracing.spans()
             if s.name == "pft.kernels.load"]
    return sum(loads) if loads else None
