"""Set-up (s): from the process's start to the window's first request,
the data made, the index built and compacted, the kernels built or
loaded and the warm-up steps run."""


def read(w):
    return w.setup_s
