"""Set-up seconds: from the process's start to the window's (imports, the
CUDA context, the kernels' load or build, the scene, a warm request)."""


def read(run):
    return run.setup_s
