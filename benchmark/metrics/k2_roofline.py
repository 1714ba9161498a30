"""k2_roofline: the least time one card needs for the window's
Bray-Curtis numerators in their dense formulation
(``benchmark/roofline_k2.py``) as a share, in %, of the device time of
the kernels inside the program's ``phase.distance`` ranges: the same
work whatever kernel does it."""

from benchmark import roofline_k2


def read(run):
    if run.trace is None or run.mix.get("metric") != "braycurtis":
        return None
    kernel_s = run.trace["phase_kernel_s"].get("distance", 0.0)
    if kernel_s <= 0:
        return None
    bound = roofline_k2.manhattan_bound_s(int(run.config["n_samples"]),
                                          int(run.config["n_features"]))
    return 100.0 * bound * len(run.jobs) / kernel_s
