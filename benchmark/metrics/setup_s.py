"""setup_s: seconds from the process's start to the window's first unit
(imports, the CUDA context, the kernels' build or load, the cell's pool,
one warm unit)."""


def read(r):
    return r.setup_s
