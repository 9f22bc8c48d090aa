"""attempt_roofline: the least time of one attempt's work (the larger of
its bytes over the card's memory bandwidth and its operations over the
card's peak in the field's width, ``work/``) over the device time per
attempt in the traced window, in percent."""


def read(rec, peaks):
    tr = rec.get("trace")
    peak = peaks.get(rec.get("device_kind", ""))
    if not tr or tr["busy_s"] <= 0 or not peak:
        return None
    wk = rec["work"]
    flops = peak["flops_per_s"].get(wk["dtype"])
    if not flops:
        return None
    least = max(wk["bytes_per_attempt"] / peak["bytes_per_s"],
                wk["ops_per_attempt"] / flops)
    return 100.0 * least / (tr["busy_s"] / tr["attempts"])
