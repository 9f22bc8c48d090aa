"""launches_per_attempt: kernel launches in the traced window over its
attempts (the program's own kernels checked against their counters)."""


def read(rec, peaks):
    tr = rec.get("trace")
    if not tr or not tr["launches"]:
        return None
    return tr["launches"] / tr["attempts"]
