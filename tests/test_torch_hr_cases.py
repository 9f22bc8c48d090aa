"""The Params texts of chip_smoke.py's production runs (phase ``hr`` and
the optional ``lr_f32_full``, ``mr_gradp_full`` and ``hr_full``) and the
band their counts are held to, on the CPU: each text parses in both
packages to the same geometry, FreezingParams and snapshot times, and the
records the runs are held to are VALIDATION.md's."""

import dataclasses
import os

import numpy as np
import pytest
import torch

import chip_smoke
from porousfreezethaw_tpu.config import parse_param_file as jax_parse
from porousfreezethaw_tpu.models.freezing.parameters import (
    FreezingParams as JaxFreezingParams)
from porousfreezethaw_tpu_torch.cases import freezing_params_text
from porousfreezethaw_tpu_torch.config import parse_param_file
from porousfreezethaw_tpu_torch.core.grid import GridGeometry
from porousfreezethaw_tpu_torch.models.freezing.parameters import (
    FreezingParams)
from porousfreezethaw_tpu_torch.ops.cuda import stencil as st

HR = (200, 200, 400)        # (n1, n2, n3)
LR = (50, 50, 100)


def _mr_text():
    return freezing_params_text(200, 0) + (
        "\nset ball_positions_file = "
        + os.path.join(chip_smoke.REPO, "data", "spheres_positions.txt")
        + "\n")


# (name, text, (n1, n2, n3), calc_mode, the last snapshot)
CASES = [
    ("hr_gradp", lambda: chip_smoke.golden_text(
        "Params-LR-GradP", chip_smoke.HR_GRID_NODES), HR, 0, 99),
    ("hr_temp_to_2", lambda: chip_smoke.golden_text(
        "Params-LR-Temp", chip_smoke.HR_GRID_NODES, 2), HR, 2, 2),
    ("lr_gradp", lambda: chip_smoke.golden_text("Params-LR-GradP"), LR, 0,
     99),
    ("lr_temp", lambda: chip_smoke.golden_text("Params-LR-Temp"), LR, 2, 99),
    ("mr_gradp", _mr_text, (100, 100, 200), 0, 99),
]


def _both(text, tmp_path):
    env = {"OUTPUT": str(tmp_path)}
    return parse_param_file(text, env=env), jax_parse(text, env=env)


@pytest.mark.parametrize("name,make,dims,mode,last", CASES,
                         ids=[c[0] for c in CASES])
def test_params_parse_alike(name, make, dims, mode, last, tmp_path):
    """Both packages read the geometry, the calc mode and FreezingParams
    of the text alike, and the grid is the one intended (the HR grid's
    lines appended to an LR golden win over its own)."""
    pt, pj = _both(make(), tmp_path)
    for pf in (pt, pj):
        assert tuple(int(pf.vars[k]) for k in ("n1", "n2", "n3")) == dims
        assert int(pf.vars["calc_mode"]) == mode
        assert int(pf.vars["saved_files"]) == last + 1
    assert dataclasses.asdict(FreezingParams.from_dict(pt.vars)) == \
        dataclasses.asdict(JaxFreezingParams.from_dict(pj.vars))
    for key in ("L1", "L2", "L3", "delta", "tau", "tau_min", "final_time"):
        assert pt.vars[key] == pj.vars[key], key
    assert pt.icond_formulas == pj.icond_formulas


@pytest.mark.parametrize("name,make,dims,mode,last", CASES,
                         ids=[c[0] for c in CASES])
def test_snapshot_times(name, make, dims, mode, last, tmp_path):
    """The apps' snapshot times final_time * k / (saved_files - 1) are
    36000 k / 99 s in both packages, a truncated run's too."""
    pt, pj = _both(make(), tmp_path)
    times = []
    for pf in (pt, pj):
        ft, n = pf.vars["final_time"], int(pf.vars["saved_files"])
        times.append([ft * k / (n - 1) for k in range(1, n)])
    assert times[0] == times[1]
    assert times[0] == pytest.approx(
        [36000.0 * k / 99 for k in range(1, last + 1)], rel=1e-14)


def test_hr_app_and_resume_texts(tmp_path):
    """The HR app run's text (t = HR_APP_FINAL_TIME, two snapshots) and
    the resumed LR run's (continue_series from a checkpoint) parse alike
    in both packages."""
    hr = chip_smoke.golden_text("Params-LR-GradP", chip_smoke.HR_GRID_NODES)
    hr += f"final_time {chip_smoke.HR_APP_FINAL_TIME}\nsaved_files 2\n"
    resume = chip_smoke.golden_text("Params-LR-GradP") + (
        f"set icond_file = {tmp_path}/image.050.ncd\nset continue_series\n")
    for text in (hr, resume):
        pt, pj = _both(text, tmp_path)
        assert pt.vars == pj.vars
        for key in ("icond_file", "continue_series", "ball_positions_file"):
            assert pt.setting(key) == pj.setting(key)
    pt, _ = _both(resume, tmp_path)
    assert pt.flag("continue_series")
    assert pt.setting("icond_file").endswith("image.050.ncd")
    pt, _ = _both(hr, tmp_path)
    assert pt.vars["final_time"] == chip_smoke.HR_APP_FINAL_TIME
    assert tuple(int(pt.vars[k]) for k in ("n1", "n2", "n3")) == HR


# the records of the band, each with the lines of VALIDATION.md that hold
# both of its numbers
RECORDS = [
    ("lr_gradp_steps", chip_smoke.LR_GRADP_STEPS),
    ("lr_gradp_attempts", chip_smoke.LR_GRADP_ATTEMPTS),
    ("lr_temp_steps_99", {99: chip_smoke.LR_TEMP_STEPS[99]}),
    ("lr_temp_attempts", chip_smoke.LR_TEMP_ATTEMPTS),
    ("mr_gradp_steps", chip_smoke.MR_GRADP_STEPS),
    ("mr_gradp_attempts", chip_smoke.MR_GRADP_ATTEMPTS),
    ("hr_temp_steps", chip_smoke.HR_TEMP_STEPS),
    ("hr_temp_attempts", chip_smoke.HR_TEMP_ATTEMPTS),
]


@pytest.mark.parametrize("name,record", RECORDS, ids=[r[0] for r in RECORDS])
def test_records_are_validation_md(name, record):
    """Each (reference, JAX) pair of the band is written in VALIDATION.md
    with its thousands separators, as its tables give them."""
    text = open(os.path.join(chip_smoke.REPO, "VALIDATION.md")).read()
    for k, (ref, jax) in record.items():
        assert f"{ref:,}" in text, (name, k, ref)
        assert f"{jax:,}" in text, (name, k, jax)


def test_lr_temp_band_uses_the_narrow_ratio():
    """The JAX run's LR Temp counts at snapshots 25/50/75 are recorded
    only as the reference's times 1.030 +- 0.002: the band takes 1.028,
    which gives the narrower upper bound."""
    for k, ref in chip_smoke.TEMP_FULL_STEPS.items():
        got_ref, jax = chip_smoke.LR_TEMP_STEPS[k]
        assert got_ref == ref
        if k != 99:
            assert jax == round(1.028 * ref)


@pytest.mark.parametrize("port,missed", [
    ((100, 100), False),           # inside
    ((95, 95), False),             # 0.95 min(ref, jax), the lower edge
    ((94, 100), True),             # below
    ((116, 100), True),            # above 1.05 max(ref, jax) = 115.5
    ((100, 116), True),            # attempts above
    (None, True),                  # the snapshot is missing
], ids=["inside", "lower_edge", "below", "above", "attempts_above",
        "missing"])
def test_band_misses(port, missed):
    """0.95 min(ref_k, jax_k) <= port_k <= 1.05 max(ref_k, jax_k) for
    steps and attempts; a missing snapshot is a miss."""
    counts = {} if port is None else {7: port}
    got = chip_smoke.band_misses(counts, {7: (100, 110)}, {7: (110, 100)})
    assert bool(got) == missed


@pytest.mark.parametrize("spacing,h,grows", [
    (3e-4, 0.05, False),                     # MR's spacing, MR's step
    (1.5e-4, 0.05, True),                    # HR's spacing, MR's step
    (1.5e-4, chip_smoke.HR_CHAIN_H, False),  # HR's spacing, its step
], ids=["mr", "hr_mr_step", "hr_chain_step"])
def test_attempt_chain_growth(spacing, h, grows):
    """The whole classic attempt on chip_smoke's random inputs grows a
    one-ulp change of u with h / dx^2: at HR's spacing and h = 0.05 its
    y_spec moves by more than the kernels' tolerance (1e-5 of max|y_spec|),
    so a kernel's rounding cannot be told from a fault there, and phase hr
    checks the whole attempt at HR_CHAIN_H (MR's h / dx^2), where it moves
    as little as at MR; each launch is still checked at h = 0.05."""
    _, prm = chip_smoke._mr_params()
    shape = (40, 20, 20)
    geom = GridGeometry(20 * spacing, 20 * spacing, 40 * spacing, 20, 20,
                        40)
    w, _ = chip_smoke._inputs(shape, torch.device("cpu"),
                              np.random.default_rng(chip_smoke.SEED))
    w_ulp = w.clone()
    w_ulp[0] = torch.from_numpy(np.nextafter(w[0].numpy(),
                                             np.float32(np.inf)))
    t = prm.phase_switch_time - 0.5 * h
    specs = []
    for y in (w, w_ulp):
        att = st.FusedAttempt(geom, prm, 0, plain=True)
        carry = att.pack(y)
        att.attempt(t, h, carry)
        specs.append(carry[0][1, :2].double())
    moved = float((specs[0] - specs[1]).abs().max()
                  / specs[0].abs().max())
    assert (moved > 1e-5) == grows, moved
