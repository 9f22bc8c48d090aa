"""DEM -> freezing-simulator offline coupling.

The reference pipeline: the DEM settle produces resting sphere centers,
``extract_final_positions.m:1-11`` writes them as tab-separated ``x y z``
rows (``spheres_final_positions.txt``), and the freezing simulator reads
that file to build its static glass phase field
(``apps/intertrack-hybrid-S-freezing/equation.c:34-35,474-529``).

This module is the writer side; the reader is
``models/freezing/glass.py::read_ball_positions``.

A numpy-only copy of ``porousfreezethaw_tpu/models/dem/coupling.py``.
"""

from __future__ import annotations

from typing import Dict, Union

import numpy as np


def write_final_positions(path: str,
                          state_or_pos: Union[Dict, np.ndarray]) -> None:
    """Write resting sphere centers as tab-separated ``x y z`` rows —
    the ``extract_final_positions.m`` contract consumed by
    ``equation.c:474-483`` (raw unit-box coordinates; the freezing app
    applies ``beads_scaling``/``beads_offset_*`` on read)."""
    pos = state_or_pos["pos"] if isinstance(state_or_pos, dict) \
        else state_or_pos
    pos = np.asarray(pos, dtype=np.float64)
    if pos.ndim != 2 or pos.shape[1] != 3:
        raise ValueError(f"expected (n, 3) positions, got {pos.shape}")
    with open(path, "w") as f:
        for x, y, z in pos:
            f.write(f"{x:.17g}\t{y:.17g}\t{z:.17g}\n")
