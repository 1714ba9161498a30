"""setup_s: process start to the first timed job: the cohort, the store,
the first build of the kernels, one warm job."""


def read(run):
    return run.setup_s
