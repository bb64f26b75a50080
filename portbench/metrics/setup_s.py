"""setup_s: seconds from the process's start to its first timed batch or
step (host clock): the CUDA context, the data or weights drawn, the kernels
built and every shape warmed up."""


def read(run):
    return run.setup_s
