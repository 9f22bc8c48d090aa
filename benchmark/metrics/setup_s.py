"""setup_s: from the process's start to the first timed attempt: imports,
the kernel build or load, the case's set-up and the warm-up call that
captures the graph."""


def read(rec, peaks):
    return rec["setup_s"]
