"""The port's analysis observables (``analysis.py``, PyTorch) and its
numpy-only copies of the exporters, the DEM CSV snapshots, the native IO
library's bindings and the final-positions writer, against the JAX
package's on the same seeded inputs, on the CPU.

Tolerances: eps_s by its integer hit count, exactly (both sides sum in
f64); the means to 1e-14 relative (sums taken in other orders); every file
byte for byte."""

import math

import numpy as np
import pytest
import torch

from porousfreezethaw_tpu import analysis as janalysis
from porousfreezethaw_tpu.io import csv_snaps as jcsv
from porousfreezethaw_tpu.io import exporters as jexp
from porousfreezethaw_tpu.io.snapshots import write_snapshot
from porousfreezethaw_tpu.models.dem import coupling as jcoupling
from porousfreezethaw_tpu.core.grid import GridGeometry
from porousfreezethaw_tpu_torch import analysis, native
from porousfreezethaw_tpu_torch.core.device import DeviceError
from porousfreezethaw_tpu_torch.io import csv_snaps, exporters
from porousfreezethaw_tpu_torch.models.dem import write_final_positions
from tests.test_freezing_equation import default_params

torch.set_num_threads(1)
CPU = "cpu"


def hits(eps, res):
    return round(eps * res**3)


class TestObservables:
    def test_ice_fraction_and_freezing_point(self):
        rng = np.random.default_rng(3)
        p, u = rng.random((6, 7, 8)), rng.standard_normal((6, 7, 8))
        assert analysis.ice_volume_fraction(p, device=CPU) == pytest.approx(
            janalysis.ice_volume_fraction(p), rel=1e-14)
        assert analysis.freezing_point_statistic(
            u, p, device=CPU) == pytest.approx(
            janalysis.freezing_point_statistic(u, p), rel=1e-14)
        # a tensor argument keeps its device; the closed forms of
        # tests/test_analysis.py
        q = torch.zeros((4, 4, 4), dtype=torch.float64)
        q[:2] = 1.0
        assert analysis.ice_volume_fraction(q) == 0.5
        p2 = np.zeros((2, 2, 2))
        p2[0, 0, 0] = 1.0
        assert analysis.freezing_point_statistic(
            np.full((2, 2, 2), -10.0), p2,
            device=CPU) == pytest.approx(10.0 / 8.0)

    def test_default_device_is_the_card(self, tmp_path, monkeypatch):
        """Without ``device``, a numpy input or a file series goes to the
        GPU, and each entry point refuses where there is none."""
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        p = np.zeros((2, 2, 2))
        for call in (lambda: analysis.ice_volume_fraction(p),
                     lambda: analysis.freezing_point_statistic(p, p),
                     lambda: analysis.eps_s(np.full((1, 3), 0.5), res=4)):
            with pytest.raises(DeviceError):
                call()
        csv_snaps.write_dem_snapshot(
            csv_snaps.snapshot_path(str(tmp_path), 2),
            {"pos": np.full((1, 3), 0.5), "vel": np.zeros((1, 3))},
            np.zeros(1), angular=False)
        with pytest.raises(DeviceError):
            analysis.eps_s_series(str(tmp_path), res=4, snapshots=2)

    @pytest.mark.parametrize("n,res,seed", [(12, 40, 0), (200, 50, 1)])
    def test_eps_s_hit_counts_equal_jax(self, n, res, seed):
        pos = np.random.default_rng(seed).random((n, 3))
        got = analysis.eps_s(pos, r=0.1, res=res, device=CPU)
        want = janalysis.eps_s(pos, r=0.1, res=res)
        assert hits(got, res) == hits(want, res) > 0
        assert got == hits(got, res) / res**3

    def test_eps_s_single_and_overlapping_spheres(self):
        pos = np.array([[0.5, 0.5, 0.5]])
        assert analysis.eps_s(pos, r=0.1, res=100,
                              device=CPU) == pytest.approx(
            4 / 3 * math.pi * 0.1**3, rel=0.05)
        one = analysis.eps_s(pos, r=0.1, res=50, device=CPU)
        two = analysis.eps_s(np.repeat(pos, 2, axis=0), r=0.1, res=50,
                             device=CPU)
        assert two == 2 * one

    def test_eps_s_series_equals_jax(self, tmp_path):
        rng = np.random.default_rng(4)
        color = np.arange(12.0)
        for snap in range(1, 5):
            state = {"pos": rng.random((12, 3)), "vel": rng.random((12, 3))}
            csv_snaps.write_dem_snapshot(
                csv_snaps.snapshot_path(str(tmp_path), snap), state, color,
                angular=False)
        got = analysis.eps_s_series(str(tmp_path), res=30, snapshots=4,
                                    device=CPU)
        want = janalysis.eps_s_series(str(tmp_path), res=30, snapshots=4)
        assert len(got) == 2
        assert [hits(g, 30) for g in got] == [hits(w, 30) for w in want]

    def test_series_statistics_equal_jax(self, tmp_path):
        geom = GridGeometry(0.03, 0.03, 0.06, 4, 4, 8)
        prm = default_params()
        for snap, frac in enumerate([0.0, 0.25, 0.5]):
            fields = np.zeros((3,) + geom.shape)
            fields[0] = 270.0 + np.arange(geom.n1)
            fields[1, :int(8 * frac)] = 1.0
            write_snapshot(str(tmp_path / f"image.{snap:03d}.ncd"), geom,
                           prm, fields, calc_mode=0, delta=1e-3, tau=1.0,
                           t=float(snap), final_time=2.0, snapshot=snap,
                           total_snapshots=3)
        got = analysis.series_statistics(str(tmp_path), device=CPU)
        want = janalysis.series_statistics(str(tmp_path))
        assert got["t"] == want["t"] == [0.0, 1.0, 2.0]
        for k in ("ice_fraction", "freezing_point"):
            assert got[k] == pytest.approx(want[k], rel=1e-14)
        assert got["ice_fraction"] == [0.0, 0.25, 0.5]


class TestExporters:
    """Every exporter writes the JAX package's bytes; the importers read
    them back alike."""

    def test_vtk(self, tmp_path):
        data = np.random.default_rng(0).standard_normal((2, 3, 4))
        for mod, name in ((exporters, "a.vtk"), (jexp, "b.vtk")):
            mod.vtk_export(str(tmp_path / name), data, comment="field")
        a, b = tmp_path / "a.vtk", tmp_path / "b.vtk"
        assert a.read_bytes() == b.read_bytes()
        assert exporters.vtk_get_grid_dim(str(a)) == (4, 3, 2)
        np.testing.assert_array_equal(exporters.vtk_import(str(a)),
                                      jexp.vtk_import(str(a)))
        ints = np.arange(24).reshape(2, 3, 4)
        exporters.vtk_export(str(a), ints)
        jexp.vtk_export(str(b), ints)
        assert a.read_bytes() == b.read_bytes()

    def test_plain_gnuplot_and_precision(self, tmp_path):
        data = np.random.default_rng(1).standard_normal((5, 3))
        a, b = str(tmp_path / "a"), str(tmp_path / "b")
        for prec in (6, 3):
            exporters.set_export_fp_precision(prec)
            jexp.set_export_fp_precision(prec)
            try:
                exporters.plain_export(a, data, comment="c")
                jexp.plain_export(b, data, comment="c")
                assert open(a, "rb").read() == open(b, "rb").read()
                exporters.gnuplot_export(a, data[:2])
                jexp.gnuplot_export(b, data[:2])
                assert open(a, "rb").read() == open(b, "rb").read()
            finally:
                exporters.set_export_fp_precision(6)
                jexp.set_export_fp_precision(6)
        exporters.plain_export(a, data)
        np.testing.assert_allclose(exporters.plain_import(a), data,
                                   rtol=1e-5)

    @pytest.mark.parametrize("binary", [True, False])
    @pytest.mark.parametrize("maxcolor", [255, 1023])
    def test_pgm_ppm(self, tmp_path, binary, maxcolor):
        img = np.linspace(0, 1, 12).reshape(3, 4)
        a, b = str(tmp_path / "a"), str(tmp_path / "b")
        exporters.pgm_export(a, img, maxcolor=maxcolor, comment="g",
                             binary=binary)
        jexp.pgm_export(b, img, maxcolor=maxcolor, comment="g",
                        binary=binary)
        assert open(a, "rb").read() == open(b, "rb").read()
        assert exporters.pnm_get_dim(a) == (4, 3, "P5" if binary else "P2")
        np.testing.assert_array_equal(exporters.pnm_import(a),
                                      jexp.pnm_import(b))
        exporters.ppm_export(a, img, 1 - img, img * 0.5, maxcolor=maxcolor,
                             binary=binary)
        jexp.ppm_export(b, img, 1 - img, img * 0.5, maxcolor=maxcolor,
                        binary=binary)
        assert open(a, "rb").read() == open(b, "rb").read()
        assert exporters.pnm_import(a).shape == (3, 4, 3)


class TestDemFiles:
    @pytest.mark.parametrize("angular", [False, True])
    def test_csv_snapshot_bytes(self, tmp_path, monkeypatch, angular):
        """The port's CSV writer gives the JAX writer's bytes through the
        native encoder and through the Python fallback, and reads back."""
        rng = np.random.default_rng(5)
        state = {k: rng.standard_normal((7, 3))
                 for k in ("pos", "vel", "angvel")}
        color = rng.random(7)
        want = tmp_path / "jax.csv"
        jcsv.write_dem_snapshot(str(want), state, color, angular=angular)
        native_path = tmp_path / "native.csv"
        csv_snaps.write_dem_snapshot(str(native_path), state, color,
                                     angular=angular)
        assert native_path.read_bytes() == want.read_bytes()
        monkeypatch.setattr(native, "write_dem_csv_rows",
                            lambda *a: False)
        plain = tmp_path / "python.csv"
        csv_snaps.write_dem_snapshot(str(plain), state, color,
                                     angular=angular)
        assert plain.read_bytes() == want.read_bytes()
        cols = csv_snaps.read_dem_snapshot(str(plain))
        np.testing.assert_allclose(cols["x"], state["pos"][:, 0], atol=1e-6)
        assert ("avz" in cols) == angular
        assert csv_snaps.snapshot_path("out", 7) == jcsv.snapshot_path(
            "out", 7)

    def test_native_library_appends_big_endian(self, tmp_path):
        """The port's binding of the repository's native library (built at
        first use where a compiler exists): its f64 appender writes
        big-endian doubles, twice appended; without the library it
        declines, and the callers take their Python paths."""
        data = np.random.default_rng(6).standard_normal(9)
        path = str(tmp_path / "a")
        if not native.available():
            assert native.append_f64_be(path, data) is False
            return
        assert native.append_f64_be(path, data)
        assert native.append_f64_be(path, data[:2])
        want = np.concatenate([data, data[:2]]).astype(">f8").tobytes()
        assert open(path, "rb").read() == want

    def test_final_positions_bytes(self, tmp_path):
        pos = np.random.default_rng(7).random((5, 3))
        write_final_positions(str(tmp_path / "a"), {"pos": pos})
        jcoupling.write_final_positions(str(tmp_path / "b"), pos)
        assert ((tmp_path / "a").read_bytes()
                == (tmp_path / "b").read_bytes())
        with pytest.raises(ValueError, match=r"\(n, 3\)"):
            write_final_positions(str(tmp_path / "c"), pos[:, :2])
