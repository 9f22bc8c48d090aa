"""graph_capture_s: the device loop's own capture time
(``device_loop(device).capture_s``: the idle attempt, the capture of one
block of attempts and the graph's instantiation)."""


def read(rec, peaks):
    return rec["graph_capture_s"]
