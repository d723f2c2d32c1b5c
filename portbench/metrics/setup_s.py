"""Set-up: from the process's start to the window's start (imports, the
traffic made on the device, kernels built or loaded, the pipeline's
prewarm and the observation fed until its first gulp was searched)."""


def read(run):
    return run.setup_s
