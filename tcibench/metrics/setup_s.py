"""Process start to the first timed solve: the imports, the CUDA context,
loading (on a checkout's first run, building) the kernels, and the warm
solve."""


def read(run):
    return run.setup_s
