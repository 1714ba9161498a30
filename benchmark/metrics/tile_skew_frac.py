"""tile_skew_frac: the share of the gram phase by which the slowest
card's contraction of a block outlasted the fastest card's: the
program's ``gram.tile_skew_s`` (events on each card's stream around its
block work, read after the phase's closing barrier) summed over the
window, over the summed ``gram`` phases. None where no skew was counted
(fewer than two cards)."""


def read(run):
    gram = run.phase_total("gram")
    skew = run.counters.get("gram.tile_skew_s")
    if gram <= 0 or not skew:
        return None
    return skew / gram
