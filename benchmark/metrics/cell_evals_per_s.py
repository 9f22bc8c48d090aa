"""cell_evals_per_s: 5 right-hand-side evaluations of every cell per
attempt, over all the attempts and all the wall time of the window (the
program's bench.py arithmetic, 5 cells attempts / wall)."""


def read(rec, peaks):
    w = rec["window"]
    return 5.0 * w["cells"] * w["attempts"] / w["wall_s"]
