"""device_idle_share: the share of the traced window in which no
operation ran on the device, from one trace (1 - the union of the device
intervals over the window), in percent."""


def read(rec, peaks):
    tr = rec.get("trace")
    if not tr or tr["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
