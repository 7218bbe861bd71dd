"""setup_s: seconds from the process's start to the window's: imports,
the kernels' build or load, drawing the weights and the cache, the bank
build, the warm-up."""


def read(run):
    return run.setup_s
