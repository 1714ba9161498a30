"""device_idle_frac: 1 - the union of kernel, copy and set activity on a
card over the traced window, averaged over the cell's cards
(``torch.profiler``, CUPTI)."""


def read(run):
    if run.trace is None or run.trace["busy_s"] <= 0:
        return None
    return 1.0 - run.trace["busy_s"] / run.window_s
