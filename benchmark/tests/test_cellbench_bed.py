"""The glass-bead bed of every run: the app's default bed as it is, 200
spheres in the DEM's unit box, and one file that both the program and the
reference read."""

from cellbench_tiny import BENCH, ROOT, spec

from benchmark import harness
from benchmark.reference.freezing import read_bed


def test_bed_is_the_default_bed():
    got = (BENCH / harness.BED).read_bytes()
    assert got == (ROOT / "data" / "spheres_positions.txt").read_bytes()
    pts = read_bed(str(BENCH / harness.BED))
    assert pts.shape == (200, 3)
    assert (pts[:, :2] > 0).all() and (pts[:, :2] < 1).all()
    assert (pts[:, 2] > 0).all()


def test_both_sides_read_the_same_file(tmp_path):
    from porousfreezethaw_tpu_torch.config.params import parse_param_file
    cell = harness.load_cell("mr-gradp.f32", spec())
    sys_mod = harness.load_module(cell.bench_dir / "cases" / "intertrack.py")
    bed = cell.bench_dir / harness.BED
    text = sys_mod.params_text(cell.config, cell.traffic, str(bed),
                               cell.read_text)
    pf = parse_param_file(text, env={"OUTPUT": str(tmp_path)})
    assert pf.setting("ball_positions_file") == str(bed)


def test_seed_draws_only_the_compared_chunk():
    fr = [harness.seed_fraction(s) for s in (0, 1, 2**31 + 11, 98765432101)]
    assert all(0.0 <= f < 1.0 for f in fr) and len(set(fr)) == len(fr)
    assert harness.seed_fraction(7) == harness.seed_fraction(7)
