"""finalize_s: the program's ``finalize`` phase a job, the mean over the
window's jobs."""


def read(run):
    return run.phase_mean("finalize")
