"""``fmm_occupied_cells``: the program's counter ``fmm.occupied_cells`` (the
occupied cells of levels 2..L that the FMM's occupied-cell layout built:
M2L's targets) over the window's force calls. None where the counter is
not in the program, or did not grow in the window (another layout ran)."""

from benchmark import spans

snapshot = spans.snapshot


def read(run):
    key = "fmm_occupied_cells"
    grew = spans.counted(run, key, "fmm.occupied_cells")
    if not grew or not run.force_calls:
        return None
    return grew / run.force_calls
