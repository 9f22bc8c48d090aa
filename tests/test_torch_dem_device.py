"""The spheres DEM on the device-resident Merson loop (``DEMAttempt``
through ``merson_solve_device``), with the plain versions of its control
and commit kernels on the CPU, against the host loop (``merson_solve``)
bit for bit and against the JAX package's jitted ``merson_solve``.

* The device loop against the host loop at the dense bed of 12 spheres
  (seed 5, the case of tests/test_dem.py), given random velocities and
  spins and a pair in contact, to t = 0.1 (20-125 attempts, rejections
  among them): the four variants, f64 and f32, the dense term and
  ``cell_lanes``; state, t, h, steps and steps_total bit for bit.  Also
  in chunks of ``max_steps`` with a trace, through an f32 NaN backoff (a
  right-hand side poisoned in two attempts), and through a
  ``cell_lanes`` overflow, whose NaN ends the f32 run in the backoff's
  abort and the f64 run at ``max_steps``.
* Against JAX: the device loop's step counts on the windows where
  tests/test_torch_dem.py holds the host loop's (t = 0.3, all variants).
* The plain control with float64 partials (a NaN, an inf, 0, and a value
  below delta that float32 rounds to delta) and the plain commit on
  float64 planes; a 0-d float64 tensor as the scalar of ``x * a`` gives
  the product of the Python float.
* The app: with ``models.dem.attempt.uses_device_loop`` patched to True,
  its snapshots and final positions are the host loop's byte for byte;
  ``--device-buffer 4`` is ``--device-buffer 0`` byte for byte through
  both loops, with one fetch a batch.  ``dem_solver`` picks the device
  loop on the card, a mesh of one device's shards included, and the host
  loop on the CPU and over several cards.
"""

import math
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from porousfreezethaw_tpu.models import dem as jdem
from porousfreezethaw_tpu.solvers import (
    MersonParams as JParams, merson_init as jinit, merson_solve as jsolve)
from porousfreezethaw_tpu_torch.apps import spheres
from porousfreezethaw_tpu_torch.models.dem import (
    DEMAttempt, DEMConfig, dem_solver, icond_dense, make_dem_rhs,
    solve_guarded)
from porousfreezethaw_tpu_torch.models.dem import attempt as dem_attempt
from porousfreezethaw_tpu_torch.ops.cuda import control as ctl_mod
from porousfreezethaw_tpu_torch.parallel.sharding import make_mesh
from porousfreezethaw_tpu_torch.solvers.merson import (
    MAX_STEPS, NAN_ABORT, MersonParams, host_loop_reason, merson_init,
    merson_solve, merson_solve_device)

torch.set_num_threads(1)

VARIANTS = ["basic", "basic_WB", "friction", "friction_angular"]
DTYPES = {"f64": torch.float64, "f32": torch.float32}
TF = 0.3


def bed(variant, dtype, n=12, seed=5, moving=False):
    """The dense bed (tests/test_dem.py's app case); ``moving``: with
    tests/test_torch_dem.py's random velocities, spins and contact."""
    cfg = DEMConfig(variant=variant, n=n)
    y0, _ = icond_dense(cfg, seed=seed)
    if moving:
        rng = np.random.RandomState(4)
        y0["vel"] = rng.standard_normal((n, 3))
        if cfg.angular:
            y0["angvel"] = 5.0 * rng.standard_normal((n, 3))
        y0["pos"][1] = y0["pos"][0] + [2 * cfg.r * 0.9, 0, 0]
    return cfg, {k: torch.as_tensor(v, dtype=dtype) for k, v in y0.items()}


def params(dtype, **kw):
    cfg = DEMConfig()
    return MersonParams(delta=cfg.delta, h_min=cfg.ht_min,
                        handle_nan=dtype == torch.float32, **kw)


def assert_bitwise(a, b):
    assert a[1] == b[1]
    sa, sb = a[0], b[0]
    assert (sa.t, sa.h, sa.steps, sa.steps_total) == (
        sb.t, sb.h, sb.steps, sb.steps_total)
    assert sorted(sa.y) == sorted(sb.y)
    for k in sa.y:
        assert sa.y[k].dtype == sb.y[k].dtype
        assert torch.equal(sa.y[k], sb.y[k]), k
    if len(a) == 3:
        assert all(torch.equal(x, y) for x, y in zip(a[2], b[2]))


@pytest.mark.parametrize("neighbor", ["dense", "cell_lanes"])
@pytest.mark.parametrize("prec", list(DTYPES))
@pytest.mark.parametrize("variant", VARIANTS)
def test_device_loop_equals_host_loop(variant, prec, neighbor):
    dtype = DTYPES[prec]
    cfg, y = bed(variant, dtype, moving=True)
    rhs = make_dem_rhs(cfg, dtype=dtype, neighbor=neighbor, cell_capacity=8,
                       device="cpu")
    p = params(dtype)
    host = merson_solve(rhs, merson_init(y, 0.0, cfg.ht), 0.1, p)
    dev = merson_solve_device(merson_init(y, 0.0, cfg.ht), 0.1, p,
                              DEMAttempt(rhs))
    assert host[1] == 0 and host[0].steps_total > host[0].steps > 20
    assert_bitwise(host, dev)


@pytest.mark.parametrize("prec", list(DTYPES))
def test_chunks_with_a_trace(prec):
    """Calls of 7 attempts each, each resuming from the last, with the
    trace: every call's result bit for bit; and the same through
    solve_guarded's chunks of the cell list."""
    dtype = DTYPES[prec]
    cfg, y = bed("friction_angular", dtype, moving=True)
    rhs = make_dem_rhs(cfg, dtype=dtype, device="cpu")
    att = DEMAttempt(rhs)
    p = params(dtype, max_steps=7, record_trace=7)
    sa = sb = merson_init(y, 0.0, cfg.ht)
    statuses = []
    while True:
        a = merson_solve(rhs, sa, 0.03, p)
        b = merson_solve_device(sb, 0.03, p, att)
        assert_bitwise(a, b)
        sa, sb = a[0], b[0]
        statuses.append(a[1])
        if a[1] != MAX_STEPS:
            break
    assert len(statuses) > 2 and statuses[-1] == 0
    cells = make_dem_rhs(cfg, dtype=dtype, neighbor="cell_lanes",
                         cell_capacity=8, device="cpu")
    start = merson_init(y, 0.0, cfg.ht)
    a = solve_guarded(cells, start, 0.03, params(dtype), chunk=5)
    b = solve_guarded(DEMAttempt(cells), start, 0.03, params(dtype),
                      chunk=5)
    assert a[2] == b[2] and a[2] <= 8
    assert_bitwise(a[:2], b[:2])


def test_f32_nan_backoff():
    """An f32 right-hand side poisoned in the 2nd and 5th attempts (five
    calls each; both loops call it in one order): the backoff cuts h
    tenfold each time, and the run goes on; both loops alike, bit for
    bit."""
    cfg, y = bed("friction_angular", torch.float32, moving=True)
    rhs = make_dem_rhs(cfg, dtype=torch.float32, device="cpu")
    nan = torch.tensor(math.nan, dtype=torch.float32)

    def run(loop):
        calls = []

        def poisoned(t, y):
            calls.append(t)
            out = rhs(t, y)
            if (len(calls) - 1) // 5 in (1, 4):
                out["vel"] = torch.where(out["vel"] > 0, nan, out["vel"])
            return out

        for attr in ("cfg", "dtype", "mesh", "neighbor_struct"):
            setattr(poisoned, attr, getattr(rhs, attr))
        p = params(torch.float32, record_trace=8)
        st = merson_init(y, 0.0, cfg.ht)
        if loop == "host":
            return merson_solve(poisoned, st, 0.02, p)
        return merson_solve_device(st, 0.02, p, DEMAttempt(poisoned))

    a = run("host")
    assert_bitwise(a, run("device"))
    assert a[1] == 0 and a[0].steps_total >= a[0].steps + 2


@pytest.mark.parametrize("prec", list(DTYPES))
def test_cell_overflow_poisons(prec):
    """Twelve spheres in one cell at capacity 8: cell_lanes returns NaN.
    f32 (the backoff) ends in its abort, f64 at max_steps with every
    attempt rejected; both loops alike, bit for bit."""
    dtype = DTYPES[prec]
    cfg = DEMConfig(variant="friction_angular", n=12)
    rng = np.random.RandomState(0)
    y = {"pos": torch.as_tensor(0.15 + 0.01 * rng.random_sample((12, 3)),
                                dtype=dtype),
         "vel": torch.zeros(12, 3, dtype=dtype),
         "angvel": torch.zeros(12, 3, dtype=dtype)}
    rhs = make_dem_rhs(cfg, dtype=dtype, neighbor="cell_lanes",
                       cell_capacity=8, device="cpu")
    assert rhs.neighbor_struct.cell_occupancy(y["pos"]) > 8
    p = params(dtype, max_steps=40)
    a = merson_solve(rhs, merson_init(y, 0.0, cfg.ht), 1.0, p)
    b = merson_solve_device(merson_init(y, 0.0, cfg.ht), 1.0, p,
                            DEMAttempt(rhs))
    assert_bitwise(a, b)
    assert a[0].steps == 0
    assert a[1] == (NAN_ABORT if dtype == torch.float32 else MAX_STEPS)


def to_jax(y):
    return {k: jnp.asarray(v.numpy()) for k, v in y.items()}


@pytest.mark.parametrize("variant", VARIANTS)
def test_step_counts_equal_jax(variant):
    """The windows of tests/test_torch_dem.py::
    test_merson_window_step_counts_equal_jax (f64, t = 0.3), JAX run as
    that test runs it: the device loop's counts are JAX's."""
    cfg, y = bed(variant, torch.float64)
    jcfg = jdem.DEMConfig(variant=variant, n=12)
    jst, jstatus = jax.jit(lambda st: jsolve(
        jdem.make_dem_rhs(jcfg), st, TF,
        JParams(delta=cfg.delta, h_min=cfg.ht_min)))(
        jinit(to_jax(y), 0.0, cfg.ht))
    st, status = merson_solve_device(
        merson_init(y, 0.0, cfg.ht), TF, params(torch.float64),
        DEMAttempt(make_dem_rhs(cfg, device="cpu")))
    assert status == int(jstatus) == 0
    assert (st.steps, st.steps_total) == (int(jst.steps),
                                          int(jst.steps_total))
    assert st.t == pytest.approx(float(jst.t), rel=1e-12)


def test_refuses_a_mesh_rhs_and_a_foreign_state():
    """A mesh right-hand side's attempt refuses a mesh whose shards lie on
    several devices (the device loop serves one) and a state that is not
    the list of its shards' dicts; the single-device one refuses a state
    of other leaves or another dtype."""
    cfg, y = bed("friction_angular", torch.float64)
    two = make_mesh("p2", [torch.device("cpu"), torch.device("meta")])
    with pytest.raises(ValueError, match="share one device"):
        DEMAttempt(make_dem_rhs(cfg, mesh=two))._dev_alloc(
            torch.device("cpu"), False)
    sharded = DEMAttempt(make_dem_rhs(cfg, mesh=make_mesh("p2",
                                                          device="cpu")))
    with pytest.raises(ValueError, match="shards' dict states"):
        merson_solve_device(merson_init(y, 0.0, 0.1), TF,
                            params(torch.float64), sharded)
    att = DEMAttempt(make_dem_rhs(cfg, device="cpu"))
    p = params(torch.float64)
    with pytest.raises(ValueError, match="leaves"):
        merson_solve_device(merson_init({"pos": y["pos"]}, 0.0, 0.1), TF, p,
                            att)
    with pytest.raises(ValueError, match="float32"):
        merson_solve_device(merson_init(
            {k: v.float() for k, v in y.items()}, 0.0, 0.1), TF, p, att)


def test_dem_solver_picks_the_loop():
    """The one rule (solvers.merson.uses_device_loop): the device loop on
    the card, without a mesh or on a mesh whose shards share one device;
    the host loop on the CPU and on a mesh over several cards (a
    DEMAttempt is made without touching the card)."""
    cfg, _ = bed("friction_angular", torch.float64)
    rhs = make_dem_rhs(cfg, device="cpu")
    sharded = make_dem_rhs(cfg, mesh=make_mesh("p2", device="cpu"))
    on_card = dem_solver(rhs, torch.device("cuda"))
    assert isinstance(on_card, DEMAttempt) and on_card.rhs is rhs
    assert dem_solver(rhs, torch.device("cpu")) is rhs
    one_device = dem_solver(sharded, torch.device("cuda"))
    assert isinstance(one_device, DEMAttempt) and one_device.rhs is sharded
    assert dem_solver(sharded, torch.device("cpu")) is sharded
    cards = make_mesh("p2", [torch.device("cuda", 0),
                             torch.device("cuda", 1)])
    across = types.SimpleNamespace(mesh=cards)
    assert dem_solver(across, torch.device("cuda")) is across
    assert host_loop_reason(torch.device("cuda"), cards) == (
        "shards on 2 devices")


# --------------------------------------------------------------------------
# the plain control and commit on float64
# --------------------------------------------------------------------------

def control_step(parts, **fields):
    """control_plain on a fresh block (t = 1, h = 0.01, delta = 0.1) with
    the eps partials ``parts``; the block after the step."""
    block = ctl_mod.ControlBlock(torch.device("cpu"), parts)
    c = ctl_mod.Control(t=1.0, h=0.01, h_cont=0.01, tf=1e9, delta=0.1,
                        max_steps=2**62, eps=parts.data_ptr(),
                        eps_n=parts.numel(),
                        eps_f64=int(parts.dtype == torch.float64))
    for k, v in fields.items():
        setattr(c, k, v)
    ctl_mod.next_scalars_plain(c)
    block.write(c)
    ctl_mod.merson_control(block)
    return block.read()


def test_control_plain_on_float64_partials():
    small = 1e-9
    below = math.nextafter(0.1, 0.0)      # < delta; float32 rounds to 0.1f
    assert float(np.float32(below)) >= 0.1

    def parts(peak, dtype=torch.float64):
        return torch.tensor([small, peak, small], dtype=dtype)

    c = control_step(parts(below))
    assert c.accept == 1 and c.steps == 1 and c.t == 1.01
    c32 = control_step(parts(below, torch.float32))
    assert c32.accept == 0 and c32.t == 1.0
    c = control_step(torch.zeros(3, dtype=torch.float64))
    assert c.accept == 1 and c.h == 0.02              # eps = 0: factor 2
    c = control_step(parts(math.nan))
    assert c.accept == 0 and c.h == 0.02              # NaN: factor 2
    c = control_step(parts(math.nan), handle_nan=1)
    assert c.accept == 0 and c.h == 0.01 / 10.0       # the backoff
    c = control_step(parts(math.inf))
    assert c.accept == 0 and c.h == 0.0               # inf: factor 0
    c = control_step(parts(math.inf), handle_nan=1)
    assert c.accept == 0 and c.h == 0.01 / 10.0
    # the float64 coefficients of the next attempt, as Python forms them
    h = c.h
    assert list(c.hs) == [h / 3, h / 6, h / 8, h]


@pytest.mark.parametrize("accept", [0, 1])
def test_commit_plain_on_float64_planes(accept):
    rng = np.random.default_rng(3)
    hi = torch.from_numpy(rng.standard_normal((3, 12, 3)))
    src = torch.from_numpy(rng.standard_normal((3, 12, 3)))
    want = (src if accept else hi).clone()
    block = ctl_mod.ControlBlock(torch.device("cpu"),
                                 torch.zeros(3, dtype=torch.float64))
    block.write(ctl_mod.Control(accept=accept))
    ctl_mod.commit(block, ctl_mod.COMMIT_COPY, hi, src=src)
    assert hi.dtype == torch.float64 and torch.equal(hi, want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_scalar_tensor_rounds_as_a_python_float(dtype):
    """``x * a`` with ``a`` a 0-d float64 tensor (a view of the control
    block, as DEMAttempt's stages read h) equals ``x * a`` with the
    Python float: the same dtype, the same bits."""
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.standard_normal(4096)).to(dtype)
    block = ctl_mod.ControlBlock(torch.device("cpu"),
                                 torch.zeros(1, dtype=torch.float64))
    for h in rng.uniform(1e-9, 0.5, 64).tolist() + [0.1, 1 / 3]:
        c = ctl_mod.Control(h=h)
        ctl_mod.next_scalars_plain(c)
        block.write(c)
        for a, view in zip((h / 3, h / 6, h / 8, h), block.hs):
            got = x * view
            assert view.dim() == 0 and got.dtype == dtype
            assert torch.equal(got, x * a)
            assert torch.equal(x + got, x + x * a)


# --------------------------------------------------------------------------
# the app
# --------------------------------------------------------------------------

BASE = ["--variant", "friction_angular", "--n", "12", "--snapshots", "6",
        "--final-time", "0.3", "--seed", "5", "--device", "cpu"]


def run_app(out, *extra):
    assert spheres.main(BASE + ["--output", str(out),
                                "--final-positions", str(out / "final.txt"),
                                *extra]) == 0
    return {p.name: p.read_bytes() for p in sorted(out.iterdir())}


@pytest.fixture(scope="module")
def host_run(tmp_path_factory):
    return run_app(tmp_path_factory.mktemp("host"))


@pytest.fixture
def fetches(monkeypatch):
    seen = []
    real = spheres.fetch

    def spy(buf):
        seen.append(tuple(buf.shape))
        return real(buf)

    monkeypatch.setattr(spheres, "fetch", spy)
    return seen


def test_app_device_loop_is_the_host_loop(tmp_path, monkeypatch, host_run):
    used = []

    def device_loop(device, mesh):
        used.append(device.type)
        return True

    monkeypatch.setattr(dem_attempt, "uses_device_loop", device_loop)
    got = run_app(tmp_path)
    assert used == ["cpu"]
    assert sorted(got) == sorted(host_run) and len(got) == 7
    for name, data in host_run.items():
        assert got[name] == data, name


@pytest.mark.parametrize("device_loop", [False, True])
def test_app_device_buffer_is_byte_identical(tmp_path, monkeypatch,
                                             host_run, fetches,
                                             device_loop):
    monkeypatch.setattr(dem_attempt, "uses_device_loop",
                        lambda device, mesh: device_loop)
    got = run_app(tmp_path, "--device-buffer", "4")
    # 6 snapshots in batches of 4 and 2: one fetch a batch
    assert fetches == [(4, 3, 12, 3)] * 2
    assert got == host_run


def test_app_device_buffer_stops_where_b0_stops(tmp_path, capsys):
    """A cell overflow at the first interval stops a buffered run as an
    unbuffered one, with no snapshot written."""
    args = ["--n", "200", "--snapshots", "3", "--final-time", "0.01",
            "--neighbor", "cell_lanes", "--cell-capacity", "1", "--device",
            "cpu", "--output", str(tmp_path)]
    msgs = []
    for extra in ([], ["--device-buffer", "2"]):
        with pytest.raises(SystemExit) as exc:
            spheres.main(args + extra)
        msgs.append(str(exc.value))
        assert not list(tmp_path.glob("snap_*.csv"))
    assert msgs[0] == msgs[1] and "exceeds capacity 1" in msgs[0]
