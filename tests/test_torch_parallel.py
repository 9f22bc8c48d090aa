"""The port's mesh paths on the CPU (``porousfreezethaw_tpu_torch.parallel``):
the mesh grammar against the JAX ``make_mesh``, sharding round trips, and
the sharded stage, delta and 2-D attempts against the port's single-device
plain paths, bit for bit, on virtual meshes whose device list repeats the
CPU.  Then a merson solve, the sharded snapshot writer, the app's
``run_iteration`` and the bench's ``--mesh`` rows, each against the same
run without a mesh.  The comparisons with the JAX package's sharded
classes are in tests/test_torch_sharded.py."""

import json
import os

import numpy as np
import pytest
import torch

from porousfreezethaw_tpu.parallel.sharding import make_mesh as jax_make_mesh
from porousfreezethaw_tpu_torch import bench
from porousfreezethaw_tpu_torch.apps.intertrack import run_iteration
from porousfreezethaw_tpu_torch.cases import freezing_params_text
from porousfreezethaw_tpu_torch.config import parse_param_file
from porousfreezethaw_tpu_torch.core.device import DeviceError
from porousfreezethaw_tpu_torch.core.grid import GridGeometry
from porousfreezethaw_tpu_torch.io.rklog import RunLog
from porousfreezethaw_tpu_torch.io.snapshots import (
    write_snapshot, write_snapshot_sharded)
from porousfreezethaw_tpu_torch.models.freezing import physics
from porousfreezethaw_tpu_torch.models.freezing.parameters import (
    FreezingParams, shift_temperature_origin)
from porousfreezethaw_tpu_torch.ops.cuda import stencil as st
from porousfreezethaw_tpu_torch.parallel import (
    gather_freezing_state, make_mesh, shard_freezing_state)
from porousfreezethaw_tpu_torch.parallel.fused import (
    ShardedDeltaAttempt, ShardedDeltaAttempt2D, halo_bytes_per_attempt,
    make_sharded_delta_attempt, make_sharded_fused_stage)
from porousfreezethaw_tpu_torch.solvers.merson import (
    MersonParams, merson_init, merson_solve)
from tests.test_intertrack_app import BASE

torch.set_num_threads(1)

CPU = torch.device("cpu")
SHAPE = (8, 8, 12)               # (n3, n2, n1)
MODES = [0, 1, 2, 10, 11]
MESHES_1D = ["z1", "z2", "z4"]
MESHES_2D = ["z1,y1", "y2", "z2,y2", "z4,y2"]


def cpu_mesh(spec):
    n = int(np.prod([int(p[1:] or 1) for p in spec.split(",")]))
    return make_mesh(spec, [CPU] * n)


@pytest.fixture(scope="module")
def case():
    """The benchmark case's parameters shifted to u - u* (the f32
    production state) and a seeded random state."""
    pf = parse_param_file(freezing_params_text(100, 0),
                          env={"OUTPUT": "unused"})
    prm = FreezingParams.from_dict(pf.vars)
    prm = shift_temperature_origin(prm, prm.u_star)
    geom = GridGeometry(0.03, 0.03, 0.06, SHAPE[2], SHAPE[1], SHAPE[0])
    rng = np.random.default_rng(11)
    w = np.stack([rng.uniform(-10, 10, SHAPE), rng.uniform(0, 1, SHAPE),
                  rng.uniform(0, 0.6, SHAPE)]).astype(np.float32)
    ks = rng.standard_normal((3, 2) + SHAPE).astype(np.float32)
    return prm, geom, torch.from_numpy(w), [torch.from_numpy(k) for k in ks]


# --------------------------------------------------------------------------
# the mesh and the shards
# --------------------------------------------------------------------------

@pytest.mark.parametrize("spec", ["z", "z4", "z2,y4", "z2,y", "y2,z2",
                                  "z3"])
def test_make_mesh_matches_jax(spec):
    """The same axes and shape as the JAX make_mesh over 8 devices."""
    import jax
    jm = jax_make_mesh(spec, jax.devices()[:8])
    m = make_mesh(spec, [CPU] * 8)
    assert m.axis_names == tuple(jm.axis_names)
    assert m.shape == dict(jm.shape)
    assert m.device_list() == [CPU] * m.size


@pytest.mark.parametrize("spec,n", [("z,y", 8), ("z16", 8), ("z3,y", 8),
                                    ("Z2", 8), ("z2,y2", 3)])
def test_make_mesh_errors_match_jax(spec, n):
    import jax
    with pytest.raises(ValueError) as jerr:
        jax_make_mesh(spec, jax.devices()[:n])
    with pytest.raises(ValueError) as err:
        make_mesh(spec, [CPU] * n)
    assert str(err.value) == str(jerr.value)


def test_make_mesh_default_devices(monkeypatch):
    assert make_mesh("z", device="cpu").device_list() == [CPU]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(DeviceError):
        make_mesh("z")


@pytest.mark.parametrize("spec", MESHES_1D + MESHES_2D)
def test_shard_gather_round_trip(case, spec):
    _, _, w, _ = case
    mesh = cpu_mesh(spec)
    shards = shard_freezing_state(w, mesh)
    nz, ny = mesh.shape.get("z", 1), mesh.shape.get("y", 1)
    assert len(shards) == mesh.size
    for s in shards:
        assert s.shape == (3, SHAPE[0] // nz, SHAPE[1] // ny, SHAPE[2])
        assert s.is_contiguous()
    # z-major, then y
    assert torch.equal(shards[-1], w[:, -(SHAPE[0] // nz):,
                                     -(SHAPE[1] // ny):])
    assert torch.equal(gather_freezing_state(shards, mesh), w)
    shards[0].zero_()                     # copies, not views of w
    assert w.abs().max() > 0
    with pytest.raises(ValueError, match="not divisible"):
        shard_freezing_state(w[:, :7], mesh if nz > 1 else cpu_mesh("y2,z2"))


def test_halo_bytes_per_attempt():
    geom = GridGeometry(0.03, 0.03, 0.06, 100, 100, 200)
    # classic: 33 planes per direction, both directions, f32
    assert halo_bytes_per_attempt(geom) == 33 * 2 * 100 * 100 * 4
    assert halo_bytes_per_attempt(geom, delta=True) == 31 * 2 * 100 * 100 * 4
    two_d = halo_bytes_per_attempt(geom, 2, 2, delta=True)
    assert two_d == (31 * 2 * 52 * 100 + 11 * 2 * 100 * 100) * 4


# --------------------------------------------------------------------------
# sharded == single-device, bit for bit (the plain versions on the CPU)
# --------------------------------------------------------------------------

def _single_attempt(prm, geom, w, mode, t, h, comp=False):
    cls = st.DeltaAttemptComp if comp else st.DeltaAttempt
    att = cls(geom, prm, mode)
    y = att.pack(w)
    (_, out), eps = att.attempt(t, h, y)
    return att, y, out, eps


def _sharded_attempt(prm, geom, w, mode, spec, t, h, **kw):
    mesh = cpu_mesh(spec)
    if "y" in mesh.axis_names:
        att = ShardedDeltaAttempt2D(geom, prm, mode, mesh)
    else:
        att = make_sharded_delta_attempt(geom, prm, mode, mesh, **kw)
    y = att.pack(shard_freezing_state(w, mesh))
    (_, out), eps = att.attempt(t, h, y)
    return att, mesh, y, out, eps


@pytest.mark.parametrize("spec,overlap", [(s, o) for s in MESHES_1D
                                          for o in (True, False)]
                         + [(s, False) for s in MESHES_2D])
def test_delta_attempt_bitwise(case, spec, overlap):
    """One increment-form attempt on every mesh, the overlap split on and
    off: y_spec and eps equal the single-device attempt's, and both
    commits equal the single-device commits."""
    prm, geom, w, _ = case
    t, h = 100.0, 0.05
    att_a, y_a, spec_a, eps_a = _single_attempt(prm, geom, w, 0, t, h)
    att_b, mesh, y_b, spec_b, eps_b = _sharded_attempt(
        prm, geom, w, 0, spec, t, h, overlap=overlap)
    assert torch.equal(gather_freezing_state(spec_b, mesh), spec_a)
    assert float(eps_b.max()) == float(eps_a.max())
    for acc in (False, True):
        ya = att_a.commit((y_a, spec_a), acc)
        yb = att_b.commit((y_b, spec_b), acc)
        assert torch.equal(gather_freezing_state(yb, mesh), ya)


@pytest.mark.parametrize("mode", MODES)
def test_every_model_bitwise(case, mode):
    """All five models: the classic stage-5 tail and plain stage at z2
    (overlap split and whole shards), and the delta attempt at z2,y2."""
    prm, geom, w, ks = case
    t, h = 100.0, 0.05
    spec = st.StencilSpec.of(geom, prm, mode)
    mesh = cpu_mesh("z2")
    combo = list(zip([0.5, -1.5, 2.0], ks))
    y_a, e_a = st.fused_stage(spec, t, h, w, combo, stage5=True)
    k_a = st.fused_stage(spec, t, h, w, combo[:2])
    ws = shard_freezing_state(w, mesh)
    combo_s = [(c, shard_freezing_state(k, mesh)) for c, k in combo]
    for overlap in (True, False):
        stage = make_sharded_fused_stage(geom, prm, mode, mesh,
                                         overlap=overlap)
        assert stage.split == overlap
        y_b, e_b = stage.stage5(t, h, ws, combo_s)
        assert torch.equal(gather_freezing_state(y_b, mesh), y_a)
        assert float(e_b.max()) == float(e_a.max())
        k_b = stage(t, h, ws, combo_s[:2])
        assert torch.equal(gather_freezing_state(k_b, mesh), k_a)
    _, _, spec_a, eps_a = _single_attempt(prm, geom, w, mode, t, h)
    _, mesh2, _, spec_b, eps_b = _sharded_attempt(prm, geom, w, mode,
                                                  "z2,y2", t, h)
    assert torch.equal(gather_freezing_state(spec_b, mesh2), spec_a)
    assert float(eps_b.max()) == float(eps_a.max())


@pytest.mark.parametrize("spec", ["z4", "z2,y2"])
def test_dirichlet_switch_bitwise(case, spec):
    """A step across phase_switch_time: the classic top ghost is D of the
    float32 t, the increment ghost dDi = D(ti) - D(t1) is nonzero, and
    both reach only the global top shard."""
    prm, geom, w, _ = case
    t, h = prm.phase_switch_time - 0.01, 0.05
    _, _, spec_a, eps_a = _single_attempt(prm, geom, w, 0, t, h)
    _, mesh, _, spec_b, eps_b = _sharded_attempt(prm, geom, w, 0, spec,
                                                 t, h)
    assert torch.equal(gather_freezing_state(spec_b, mesh), spec_a)
    assert float(eps_b.max()) == float(eps_a.max())
    # the switch is in play: the same step before it differs at the top
    _, _, before, _ = _single_attempt(prm, geom, w, 0, t - 1.0, h)
    assert (before[0, -1] - spec_a[0, -1]).abs().max() > 0
    # classic stage 1 on each side of the switch
    sp = st.StencilSpec.of(geom, prm, 0)
    stage = make_sharded_fused_stage(geom, prm, 0, cpu_mesh("z4"))
    for ts in (t, prm.phase_switch_time + 100.0):
        k = stage(ts, h, shard_freezing_state(w, cpu_mesh("z4")), [])
        assert torch.equal(gather_freezing_state(k, cpu_mesh("z4")),
                           st.fused_stage(sp, ts, h, w, []))


@pytest.mark.parametrize("spec,overlap", [("z2", True), ("z4", False)])
def test_compensated_bitwise(case, spec, overlap):
    """The compensated (emit="dy", TwoSum) attempt: dy, eps and both
    commits of the 5-plane state equal DeltaAttemptComp's."""
    prm, geom, w, _ = case
    t, h = 100.0, 0.05
    att_a, y_a, dy_a, eps_a = _single_attempt(prm, geom, w, 0, t, h, True)
    att_b, mesh, y_b, dy_b, eps_b = _sharded_attempt(
        prm, geom, w, 0, spec, t, h, overlap=overlap, compensated=True)
    assert all(y.shape[0] == 5 for y in y_b)
    assert torch.equal(gather_freezing_state(dy_b, mesh), dy_a)
    assert float(eps_b.max()) == float(eps_a.max())
    for acc in (False, True):
        ya = att_a.commit((y_a, dy_a), acc)
        yb = att_b.commit((y_b, dy_b), acc)
        assert torch.equal(gather_freezing_state(yb, mesh), ya)


@pytest.mark.parametrize("path", ["delta_z4", "delta_z2,y2", "comp_z2",
                                  "stage_z2"])
def test_merson_solve_sharded_equals_single(case, path):
    """A merson solve over a short window: the same step counts, t, h and
    final state bits as the single-device solve."""
    prm, geom, w, _ = case
    w = w.clone()
    w[0] = torch.linspace(-5, 5, SHAPE[2])
    kind, spec = path.split("_")
    mesh = cpu_mesh(spec)
    if kind == "stage":
        single = dict(stage_fn=st.make_fused_stage(geom, prm, 0))
        sharded = dict(stage_fn=make_sharded_fused_stage(geom, prm, 0, mesh))
    elif kind == "comp":
        single = dict(attempt_fn=st.DeltaAttemptComp(geom, prm, 0))
        sharded = dict(attempt_fn=ShardedDeltaAttempt(geom, prm, 0, mesh,
                                                      compensated=True))
    elif "y" in spec:
        single = dict(attempt_fn=st.DeltaAttempt(geom, prm, 0))
        sharded = dict(attempt_fn=ShardedDeltaAttempt2D(geom, prm, 0, mesh))
    else:
        single = dict(attempt_fn=st.DeltaAttempt(geom, prm, 0))
        sharded = dict(attempt_fn=ShardedDeltaAttempt(geom, prm, 0, mesh))
    params = MersonParams(delta=1e-3, handle_nan=True, max_steps=12)
    a, _ = merson_solve(None, merson_init(w, 0.0, 1e-4), 1e9, params,
                        **single)
    ys = shard_freezing_state(w, mesh)
    b, _ = merson_solve(None, merson_init(ys, 0.0, 1e-4), 1e9, params,
                        **sharded)
    assert (a.steps, a.steps_total, a.t, a.h) == (b.steps, b.steps_total,
                                                  b.t, b.h)
    assert a.steps >= 3
    assert torch.equal(gather_freezing_state(b.y, mesh), a.y)
    # the solve worked on copies of the caller's shards
    assert torch.equal(gather_freezing_state(ys, mesh), w)


# --------------------------------------------------------------------------
# the shard wrappers
# --------------------------------------------------------------------------

def test_shard_wrappers_reject_bad_inputs(case):
    prm, geom, w, ks = case
    spec = st.StencilSpec.of(geom, prm, 0)
    w4 = w[:, :4].contiguous()
    k4 = ks[0][:, :4].contiguous()
    g = (torch.zeros(3, SHAPE[1], SHAPE[2]),) * 2
    g1 = (torch.zeros(5, SHAPE[1], SHAPE[2]),) * 2
    st.fused_stage_shard(spec, 0.0, 0.1, w4, [], g)          # accepted
    with pytest.raises(ValueError, match="ghost"):
        st.fused_stage_shard(spec, 0.0, 0.1, w4, [])
    with pytest.raises(ValueError, match="shape"):
        st.fused_stage_shard(spec, 0.0, 0.1, w4, [(1.0, k4)], g)
    with pytest.raises(ValueError, match="interior part reads no ghosts"):
        st.fused_stage_shard(spec, 0.0, 0.1, w4, [], g, part="interior")
    with pytest.raises(ValueError, match="needs >= 3 planes"):
        st.fused_stage_shard(spec, 0.0, 0.1, w4[:, :2].contiguous(), [],
                             part="interior")
    with pytest.raises(ValueError, match="part must be"):
        st.fused_stage_shard(spec, 0.0, 0.1, w4, [], g, part="middle")
    with pytest.raises(ValueError, match="interior part's outputs"):
        st.fused_stage_shard(spec, 0.0, 0.1, w4, [], g, part="edge")
    # rows 2..5 of the grid need their neighbour rows in the input
    with pytest.raises(ValueError, match="window"):
        st.fused_stage_shard(spec, 0.0, 0.1, w4[:, :, :4].contiguous(), [],
                             (g[0][:, :4].contiguous(),) * 2,
                             window=(0, 4, 2))
    with pytest.raises(TypeError):
        st.delta_g_shard(spec, 0.1, 0.0, 0.0, w4.double(), [(1.0, k4)], g1,
                         is_top=True)
    with pytest.raises(ValueError, match="emit"):
        st.delta_g_shard(spec, 0.1, 0.0, 0.0, w4, [(1.0, k4)], g1,
                         is_top=True, emit="dy")
    # the CPU computes with the plain versions and counts no launch
    counts = lambda: (st.fused_stage_shard.launches,
                      st.fused_stage_shard.launches_split,
                      st.delta_g_shard.launches, st.delta_g_shard.launches_dy)
    before = counts()
    st.delta_g_shard(spec, 0.1, 0.0, 0.0, w4, [(1.0, k4)], g1, is_top=False)
    out = st.fused_stage_shard(spec, 0.0, 0.1, w4, [], None,
                               part="interior")
    st.fused_stage_shard(spec, 0.0, 0.1, w4, [], g, part="edge",
                         prev=(out,))
    assert counts() == before


def test_y_window_reads_no_chain_end_row(case):
    """A y-shard's chain-end ghost row holds NaN and never reaches K: the
    y mirror is decided on global rows."""
    prm, geom, w, _ = case
    spec = st.StencilSpec.of(geom, prm, 0)
    t, h = 100.0, 0.05
    k_ref = st.fused_stage(spec, t, h, w, [])
    half = SHAPE[1] // 2
    nan_row = torch.full((3, SHAPE[0], 1, SHAPE[2]), float("nan"))
    for y0, rows in ((0, [nan_row, w[:, :, :half + 1]]),
                     (half, [w[:, :, half - 1:], nan_row])):
        we = torch.cat(rows, dim=2).contiguous()
        lo, hi = we[:, 0].clone(), we[:, -1].clone()
        hi[0] = physics.dirichlet_top_f32(t, prm)    # the top ghost
        k = st.fused_stage_shard(spec, t, h, we, [], (lo, hi),
                                 window=(1, half, y0))
        assert torch.equal(k, k_ref[:, :, y0:y0 + half])


# --------------------------------------------------------------------------
# snapshots, the app and the bench
# --------------------------------------------------------------------------

@pytest.mark.parametrize("spec", ["z2", "z2,y2"])
def test_write_snapshot_sharded_is_byte_identical(case, tmp_path, spec):
    prm, geom, w, _ = case
    mesh = cpu_mesh(spec)
    kw = dict(calc_mode=0, delta=1e-3, tau=0.25, t=12.5, final_time=100.0,
              snapshot=1, total_snapshots=3, comment="mesh")
    u_shift = 273.15
    fields = np.array(w.numpy(), copy=True)
    fields[0] += u_shift
    write_snapshot(str(tmp_path / "a.ncd"), geom, prm, fields, **kw)
    write_snapshot_sharded(str(tmp_path / "b.ncd"), geom, prm,
                           shard_freezing_state(w, mesh), mesh,
                           u_shift=u_shift, **kw)
    assert ((tmp_path / "a.ncd").read_bytes()
            == (tmp_path / "b.ncd").read_bytes())


def _run_iteration(out, **kw):
    out.mkdir()
    text = BASE + "\nincrement_form 1\n"
    os.environ["OUTPUT"] = str(out)
    try:
        pf = parse_param_file(text, env={"OUTPUT": str(out)})
        log = RunLog(pf.setting("logfile"))
        stats = run_iteration(pf, log, device=CPU, dtype=torch.float32, **kw)
        log.close()
    finally:
        os.environ.pop("OUTPUT", None)
    return stats, (out / "intertrack.log").read_text()


def test_app_run_iteration_mesh_z2(tmp_path):
    """The app's f32 solve on a z2 mesh of two CPU entries: the same
    counts and byte-identical snapshots as without a mesh."""
    a, _ = _run_iteration(tmp_path / "single")
    b, log = _run_iteration(tmp_path / "mesh", mesh_axes="z2",
                            mesh_devices=[CPU, CPU])
    assert (a["steps"], a["steps_total"], a["t"]) == (
        b["steps"], b["steps_total"], b["t"])
    assert "(sharded over z=2)" in log and "Device mesh: {'z': 2}" in log
    names = sorted(p.name for p in (tmp_path / "single").glob("*.ncd"))
    assert len(names) == 3
    for n in names:
        assert ((tmp_path / "single" / n).read_bytes()
                == (tmp_path / "mesh" / n).read_bytes())


def test_app_mesh_refuses_unported_paths(tmp_path):
    """--mesh with f64 or a noise field is the JAX app's GSPMD fallback,
    which is not ported yet: it raises and runs nothing else."""
    pf = parse_param_file(BASE, env={"OUTPUT": str(tmp_path)})
    log = RunLog(pf.setting("logfile"))
    with pytest.raises(NotImplementedError, match="not ported yet"):
        run_iteration(pf, log, device=CPU, dtype=torch.float64,
                      mesh_axes="z2", mesh_devices=[CPU, CPU])
    noisy = parse_param_file(BASE + "\nu_noise_amp 0.01\n",
                             env={"OUTPUT": str(tmp_path)})
    with pytest.raises(NotImplementedError, match="not ported yet"):
        run_iteration(noisy, log, device=CPU, dtype=torch.float32,
                      mesh_axes="z2", mesh_devices=[CPU, CPU])
    log.close()
    assert not list(tmp_path.glob("*.ncd"))


@pytest.mark.parametrize("mesh,metric", [
    ("z1", "freezing_gradp_8_cell_rhs_evals_per_s_sharded_z1"),
    ("z1,y1", "freezing_gradp_8_cell_rhs_evals_per_s_sharded_z1,y1")])
def test_bench_mesh_rows(capsys, mesh, metric):
    """The bench's --mesh rows on the CPU: one JSON line under bench.py's
    metric name with the mesh suffix."""
    argv = ["--device", "cpu", "--grid-nodes", "8", "--steps", "3",
            "--warm-steps", "3", "--fused", "stage", "--mesh", mesh]
    assert bench.main(argv) == 0
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rec["metric"] == metric and rec["value"] > 0
    assert rec["attempts"] == 3
    assert rec["fused"] == ("delta_2d" if "y" in mesh else "stage_sharded")
    assert rec["mesh"] == ({"z": 1, "y": 1} if "y" in mesh else {"z": 1})
