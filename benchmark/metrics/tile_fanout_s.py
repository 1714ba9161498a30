"""tile_fanout_s: the device time of a job's block copies to the other
cards under the tile2d gather transport: the program's ``tile2d.fanout``
spans (a CUDA event pair on the block's stream around each copy, after
its wait for the destination) summed over the window, over the window's
jobs. None where the window made no such copy."""


def read(run):
    total = run.hist_sums.get("tile2d.fanout")
    if not run.jobs or not total:
        return None
    return total / len(run.jobs)
