"""pcoa_job_s: wall seconds of one whole job: the window's wall over the
whole jobs in it (host clock)."""


def read(run):
    return run.window_s / len(run.jobs)
