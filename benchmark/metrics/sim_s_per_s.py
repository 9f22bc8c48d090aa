"""sim_s_per_s: simulated seconds advanced in the window over its wall
time (wall per simulated hour = 3600 / this)."""


def read(rec, peaks):
    w = rec["window"]
    return (w["t_end"] - w["t_start"]) / w["wall_s"]
