"""Process start to the first timed job: imports, the CUDA context, the
kernels' build or load, the instance, one warm job."""


def read(run):
    return run.setup_s
