"""table_upload_s: the device time a job spends taking its count table:
the program's ``table.upload`` spans (a CUDA event pair around the copy
of the CSR arrays and their scatter into the zeroed table) summed over
the window, over the window's jobs."""


def read(run):
    if not run.jobs or "table.upload" not in run.hist_sums:
        return None
    return run.hist_sums["table.upload"] / len(run.jobs)
