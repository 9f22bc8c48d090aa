"""block_gap_us: the device loop's graph-block boundary on the device
clock: the mean over the boundaries of the traced stretch's solve call
(the last ``pft.solve`` span the program recorded) of its blocks'
``gap_us``, the device time from one block's end event to the next
block's start event (the control block's read-back copy and the device
idle while the host reads it and launches the next graph).  None where
the program records no such span (a program without tracing, the CPU)."""


def read(rec, peaks):
    try:
        from porousfreezethaw_tpu_torch.core import tracing
    except ImportError:
        return None
    spans = tracing.spans()
    roots = [s for s in spans if s.name == "pft.solve"]
    if not roots:
        return None
    root = roots[-1].id
    gaps = [s.attrs["gap_us"] for s in spans
            if s.root == root and s.name == "pft.loop.block"
            and "gap_us" in s.attrs]
    return sum(gaps) / len(gaps) if gaps else None
