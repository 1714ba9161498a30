"""gram_s: the program's ``gram`` phase a job (``PhaseTimer``, ended by a
device synchronise), the mean over the window's jobs."""


def read(run):
    return run.phase_mean("gram")
