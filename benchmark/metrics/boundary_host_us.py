"""boundary_host_us: the host's part of the device loop's graph-block
boundary: the mean over the boundaries of the traced stretch's solve call
(the last ``pft.solve`` span the program recorded) of the host time from
the return of one block's ``pft.loop.readback`` span to the return of
the next block's ``pft.loop.replay`` span (the halt check, the counters,
the next graph's launch), in microseconds.  A boundary is a block with
``gap_us`` (one that follows a block of the same run on the card).  None
where the program records no such span."""


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
    mine = [s for s in spans if s.root == root]
    child = {(s.parent, s.name): s for s in mine}
    blocks = [s for s in mine if s.name == "pft.loop.block"]
    host = []
    for prev, cur in zip(blocks, blocks[1:]):
        if "gap_us" not in cur.attrs:
            continue
        back = child.get((prev.id, "pft.loop.readback"))
        replay = child.get((cur.id, "pft.loop.replay"))
        if back is not None and replay is not None:
            host.append((replay.end_ns - back.end_ns) * 1e-3)
    return sum(host) / len(host) if host else None
