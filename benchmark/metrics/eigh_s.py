"""eigh_s: the program's ``eigh`` phase a job (Gower centering, the
eigensolve and the coordinates), the mean over the window's jobs."""


def read(run):
    return run.phase_mean("eigh")
