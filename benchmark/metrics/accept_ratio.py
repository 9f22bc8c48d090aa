"""accept_ratio: accepted over attempted steps in the window."""


def read(rec, peaks):
    w = rec["window"]
    return w["accepted"] / w["attempts"] if w["attempts"] else None
