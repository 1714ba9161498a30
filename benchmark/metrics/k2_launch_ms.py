"""k2_launch_ms: K2's device time a launch, in ms: the program's
``kernel.braycurtis.launch`` spans (a CUDA event pair around each
launch) summed over the window, over the window's
``kernel.braycurtis.launches``."""


def read(run):
    launches = run.counters.get("kernel.braycurtis.launches", 0.0)
    if (not run.jobs or launches <= 0
            or "kernel.braycurtis.launch" not in run.hist_sums):
        return None
    return 1000.0 * run.hist_sums["kernel.braycurtis.launch"] / launches
