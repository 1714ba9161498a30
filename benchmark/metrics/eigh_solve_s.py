"""eigh_solve_s: the eigensolver's device time a job (``torch.linalg.eigh``
or the randomized solve, the card's idle inside cuSOLVER included): the
program's ``eigh.solve`` spans summed over the window, over the window's
jobs. The ``eigh`` phase holds it, beside the centering and the
coordinates."""


def read(run):
    if not run.jobs or "eigh.solve" not in run.hist_sums:
        return None
    return run.hist_sums["eigh.solve"] / len(run.jobs)
