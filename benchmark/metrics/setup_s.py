"""setup_s: from the process's start to the window's opening: imports,
the kernels' build or load, the scene on the device and the warm-up steps."""


def read(run):
    return run.setup_s
