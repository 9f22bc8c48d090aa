"""The port's spans (``core/tracing.py``): nesting, parent and root ids,
the bounded store, the two tiers (cold spans always; the device loop's
block spans only under a recording torch.profiler session or inside
``tracing.recording()``), the spans as ``user_annotation`` events of the
profiler's Chrome trace, ``pft.solve``'s counts against the solve's
state, the app's set-up, solve and snapshot spans in its
``--profile-dir`` trace, and the benchmark's readers of the spans
(``benchmark/metrics/block_gap_us.py``, ``boundary_host_us.py``,
``kernel_library_s.py``) on a synthetic store.

On the CPU the device loop runs its plain attempts, in blocks of up to
``BLOCK`` while tracing is on.  The test marked ``cuda`` needs the card
(and runs there without the suite's conftest, which imports JAX):

    python -m pytest --noconftest -m cuda tests/test_torch_tracing.py
"""

import importlib.util
import itertools
import json
from pathlib import Path
from unittest import mock

import pytest
import torch

from porousfreezethaw_tpu_torch.apps import intertrack
from porousfreezethaw_tpu_torch.cases import freezing_params_text
from porousfreezethaw_tpu_torch.config.params import parse_param_file
from porousfreezethaw_tpu_torch.core import tracing
from porousfreezethaw_tpu_torch.core.grid import GridGeometry
from porousfreezethaw_tpu_torch.models.freezing.attempt import PlainAttempt
from porousfreezethaw_tpu_torch.models.freezing.equation import make_rhs
from porousfreezethaw_tpu_torch.models.freezing.icond import (
    build_initial_conditions)
from porousfreezethaw_tpu_torch.models.freezing.parameters import (
    PARAM_INFO, FreezingParams)
from porousfreezethaw_tpu_torch.ops.cuda.control import BLOCK
from porousfreezethaw_tpu_torch.solvers.merson import (
    MersonParams, merson_init, merson_solve_device)

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
METRICS = REPO / "benchmark" / "metrics"
HOT = ("pft.loop.block", "pft.loop.replay", "pft.loop.readback")


@pytest.fixture(autouse=True)
def empty_store():
    tracing.clear()
    yield
    tracing.clear()


def names(spans):
    return [s.name for s in spans]


def case(nodes=8, device="cpu"):
    """The freezing benchmark case at ``nodes`` cells along z, f64, on the
    plain right-hand side: (attempt object, initial state, tau, delta)."""
    pf = parse_param_file(freezing_params_text(grid_nodes=nodes))
    params = FreezingParams.from_dict(
        {name: pf.get(name) for name, _ in PARAM_INFO if name})
    geom = GridGeometry(pf.get("L1"), pf.get("L2"), pf.get("L3"),
                        pf.get_int("n1"), pf.get_int("n2"), pf.get_int("n3"))
    w0 = build_initial_conditions(geom, params, pf.icond_formulas)
    rhs = make_rhs(geom, params, 0, device)
    attempt = PlainAttempt(rhs, geom.shape, torch.float64)
    return (attempt, torch.as_tensor(w0).to(device), pf.get("tau"),
            pf.get("delta"))


def solve(attempts, chunk=None, device="cpu"):
    """``attempts`` attempts of the case through ``merson_solve_device``
    (in chunks of ``chunk`` through ``between=``): the final state."""
    attempt, y0, tau, delta = case(device=device)
    n = chunk or attempts
    prm = MersonParams(delta=delta, max_steps=n, record_trace=n)
    left = [-(-attempts // n)]

    def between(t_tr, h_tr, n_new, prev):
        left[0] -= 1
        return left[0] <= 0

    st, _, _ = merson_solve_device(merson_init(y0, 0.0, tau), 1e9, prm,
                                   attempt,
                                   between=between if chunk else None)
    return st


def test_spans_nest_with_parents_and_a_shared_root():
    with tracing.span("outer", k=1) as outer:
        with tracing.span("inner") as inner:
            with tracing.span("leaf") as leaf:
                leaf.attrs["x"] = 2
        with tracing.span("own", root=True) as own:
            with tracing.span("own.child") as own_child:
                pass
    got = tracing.spans()
    assert names(got) == ["leaf", "inner", "own.child", "own", "outer"]
    assert outer.parent is None and outer.root == outer.id
    assert inner.parent == outer.id and leaf.parent == inner.id
    assert inner.root == leaf.root == outer.id
    assert own.parent == outer.id and own.root == own.id
    assert own_child.root == own.id
    assert outer.attrs == {"k": 1} and leaf.attrs == {"x": 2}
    for s in got:
        assert s.end_ns >= s.start_ns and s.seconds >= 0.0
    assert outer.start_ns <= inner.start_ns <= leaf.start_ns
    assert leaf.end_ns <= inner.end_ns <= outer.end_ns


def test_a_span_is_recorded_when_its_block_raises():
    with pytest.raises(ValueError):
        with tracing.span("outer"):
            with tracing.span("failing"):
                raise ValueError("boom")
    assert names(tracing.spans()) == ["failing", "outer"]
    with tracing.span("after") as after:
        pass
    assert after.parent is None


def test_span_decorates_a_function_and_annotate_adds_attributes():
    @tracing.span("pft.test", fixed=1)
    def f(n):
        """f's doc."""
        tracing.annotate(n=n)
        return 2 * n

    assert f(3) == 6 and f(4) == 8
    assert f.__doc__ == "f's doc." and f.__name__ == "f"
    got = tracing.spans()
    assert [s.attrs for s in got] == [{"fixed": 1, "n": 3},
                                      {"fixed": 1, "n": 4}]
    assert got[0].id != got[1].id


def test_the_store_is_bounded():
    for i in range(tracing.STORE_LEN + 25):
        with tracing.span("s", i=i):
            pass
    got = tracing.spans()
    assert len(got) == tracing.STORE_LEN
    assert got[0].attrs["i"] == 25 and got[-1].attrs["i"] == (
        tracing.STORE_LEN + 24)


def test_recording_turns_the_hot_tier_on_and_nests():
    assert not tracing.hot()
    with tracing.recording():
        assert tracing.hot()
        with tracing.recording():
            assert tracing.hot()
        assert tracing.hot()
    assert not tracing.hot()


def test_tracing_off_records_cold_spans_and_no_hot_span():
    st = solve(70)
    got = tracing.spans()
    assert not set(HOT) & set(names(got))
    for name in ("pft.setup.params", "pft.setup.icond", "pft.setup.attempt",
                 "pft.solve", "pft.loop.begin", "pft.loop.run",
                 "pft.loop.unpack"):
        assert name in names(got), name
    assert st.steps_total == 70
    attempt_spans = [s for s in got if s.name == "pft.setup.attempt"]
    assert [s.attrs["cls"] for s in attempt_spans] == ["make_rhs",
                                                        "PlainAttempt"]
    icond = next(s for s in got if s.name == "pft.setup.icond")
    assert icond.attrs["cells"] == 4 * 4 * 8


def _hot_spans_of_one_solve(got, attempts):
    root = [s for s in got if s.name == "pft.solve"][-1]
    mine = [s for s in got if s.root == root.id]
    by_id = {s.id: s for s in mine}
    blocks = [s for s in mine if s.name == "pft.loop.block"]
    assert len(blocks) == -(-attempts // BLOCK) == root.attrs["blocks"]
    for b in blocks:
        kids = sorted((s for s in mine if s.parent == b.id),
                      key=lambda s: s.start_ns)
        assert names(kids) == ["pft.loop.replay", "pft.loop.readback"]
        assert by_id[b.parent].name == "pft.loop.run"
        # the CPU loop has no graph and no device clock
        assert "device_us" not in b.attrs and "gap_us" not in b.attrs
    return root


def test_recording_records_the_hot_spans_of_a_cpu_solve():
    with tracing.recording():
        st = solve(70)
    root = _hot_spans_of_one_solve(tracing.spans(), 70)
    assert st.steps_total == 70


def test_the_solve_span_counts_the_solve():
    st = solve(120, chunk=40)        # 3 chunks of 40 attempts: 32 + 8
    root = [s for s in tracing.spans() if s.name == "pft.solve"][-1]
    assert root.attrs["attempts"] == st.steps_total == 120
    assert root.attrs["accepted"] == st.steps > 0
    assert root.attrs["blocks"] == 3 * 2
    assert root.attrs["path"] == "PlainAttempt"
    kinds = [s.name for s in tracing.spans() if s.root == root.id]
    assert kinds.count("pft.loop.run") == 3
    assert kinds.count("pft.loop.chunk") == 3


def test_the_profiler_records_the_spans_as_annotations(tmp_path):
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        assert tracing.hot()
        solve(40)
    assert not tracing.hot()
    _hot_spans_of_one_solve(tracing.spans(), 40)
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = [e for e in json.loads(path.read_text())["traceEvents"]
              if e.get("cat") == "user_annotation" and e.get("ph") == "X"]
    solves = [e for e in events if e["name"] == "pft.solve"]
    loop = [e for e in events if e["name"].startswith("pft.loop.")]
    assert len(solves) == 1
    assert {e["name"] for e in loop} == {
        "pft.loop.begin", "pft.loop.run", "pft.loop.block",
        "pft.loop.replay", "pft.loop.readback", "pft.loop.unpack"}
    s0 = float(solves[0]["ts"])
    s1 = s0 + float(solves[0]["dur"])
    blocks = [e for e in loop if e["name"] == "pft.loop.block"]
    assert len(blocks) == 2
    for e in loop:
        assert s0 <= float(e["ts"]) and float(e["ts"]) + float(e["dur"]) <= s1
    for name in ("pft.loop.replay", "pft.loop.readback"):
        for e in (e for e in loop if e["name"] == name):
            assert any(float(b["ts"]) <= float(e["ts"]) and
                       float(e["ts"]) + float(e["dur"])
                       <= float(b["ts"]) + float(b["dur"]) for b in blocks)


def test_the_app_trace_holds_setup_solve_and_snapshot_spans(
        tmp_path, monkeypatch):
    balls = REPO / "data" / "spheres_positions.txt"
    text = freezing_params_text(grid_nodes=8, final_time_hours=1.0 / 3600.0,
                                saved_files=2)
    pfile = tmp_path / "Params"
    pfile.write_text(text + f"\nset ball_positions_file = {balls}\n")
    monkeypatch.setenv("OUTPUT", str(tmp_path))
    monkeypatch.setenv("PFT_SERVICE_CHUNK", "64")
    with mock.patch.object(intertrack, "uses_device_loop",
                           lambda device, mesh: True):
        rc = intertrack.main([str(pfile), "--precision", "f64",
                              "--device", "cpu", "--profile-dir",
                              str(tmp_path / "prof")])
    assert rc == 0
    events = json.loads((tmp_path / "prof" / "trace.json").read_text())
    got = {e["name"] for e in events["traceEvents"]
           if e.get("cat") == "user_annotation"}
    for name in ("pft.setup.params", "pft.setup.icond", "pft.setup.glass",
                 "pft.setup.attempt", "pft.solve", "pft.loop.block",
                 "pft.loop.chunk", "pft.app.service", "pft.app.snapshot"):
        assert name in got, name
    snaps = [s.attrs["snapshot"] for s in tracing.spans()
             if s.name == "pft.app.snapshot"]
    assert snaps == [0, 1]


def reader(name):
    spec = importlib.util.spec_from_file_location(
        f"reader_{name}", METRICS / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def synthetic_store():
    """Two solve calls (a retaken trace: the readers take the last), the
    second of three blocks 1 ms apart (the first without gap_us), and two
    loads of the kernel library."""
    out = []
    ids = itertools.count(1)

    def add(name, sid, parent, root, t0, t1, **attrs):
        out.append(tracing.Span(name, sid, parent, root, t0, t1, attrs))

    def one_solve(t, blocks):
        """``blocks``: (gap_us or None, the replay's end, the read-back's
        end, in ns from the block's start) each."""
        sid, run = next(ids), next(ids)
        for k, (gap, replay_end, back_end) in enumerate(blocks):
            b0, bid = t + 1_000_000 * k, next(ids)
            add("pft.loop.replay", next(ids), bid, sid, b0, b0 + replay_end)
            add("pft.loop.readback", next(ids), bid, sid, b0 + 100_000,
                b0 + back_end)
            gaps = {} if gap is None else {"gap_us": gap}
            add("pft.loop.block", bid, run, sid, b0, b0 + 900_000,
                device_us=800.0, **gaps)
        add("pft.loop.run", run, sid, sid, t, t + 10_000_000)
        add("pft.solve", sid, None, sid, t, t + 11_000_000)

    add("pft.kernels.load", next(ids), None, 0, 0, 1_500_000_000)
    one_solve(2_000_000_000, [(None, 10_000, 800_000),
                              (99.0, 10_000, 800_000)])
    one_solve(3_000_000_000, [(None, 10_000, 800_000),
                              (30.0, 20_000, 850_000),
                              (50.0, 40_000, 900_000)])
    add("pft.kernels.load", next(ids), None, 0, 0, 500_000_000)
    return out


def test_the_readers_on_a_synthetic_store(monkeypatch):
    monkeypatch.setattr(tracing, "spans", synthetic_store)
    assert reader("block_gap_us")({}, {}) == pytest.approx(40.0)
    # boundaries: block 1 ends its read-back at 0.8 ms, block 2's replay
    # ends at 1.02 ms; block 2's read-back at 1.85 ms, block 3's replay at
    # 2.04 ms: 220 and 190 us
    assert reader("boundary_host_us")({}, {}) == pytest.approx(205.0)
    assert reader("kernel_library_s")({}, {}) == pytest.approx(2.0)


def test_the_readers_find_nothing_in_an_empty_store():
    for name in ("block_gap_us", "boundary_host_us", "kernel_library_s"):
        assert reader(name)({}, {}) is None
    # a CPU solve: blocks, but no boundary on the device clock
    with tracing.recording():
        solve(70)
    assert reader("block_gap_us")({}, {}) is None
    assert reader("boundary_host_us")({}, {}) is None


@pytest.mark.cuda
def test_block_spans_on_the_card():
    """On the card: ``capture_s`` is the capture span's duration, every
    block has its device time and every block after a run's first its
    boundary's, and the readers read them."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is "
                    "False)")
    from porousfreezethaw_tpu_torch.ops.cuda import build
    try:
        build.find_nvcc()
    except build.KernelBuildError as exc:
        pytest.skip(str(exc))
    dev = torch.device("cuda:0")
    attempt, y0, tau, delta = case(nodes=16, device=dev)
    prm = MersonParams(delta=delta, max_steps=4 * BLOCK)
    merson_solve_device(merson_init(y0, 0.0, tau), 1e9, prm, attempt)
    loop = attempt.device_loop(dev)
    capture = [s for s in tracing.spans() if s.name == "pft.loop.capture"]
    assert len(capture) == 1 and loop.capture_s == capture[0].seconds
    with tracing.recording():
        merson_solve_device(merson_init(y0, 0.0, tau), 1e9, prm, attempt)
    root = [s for s in tracing.spans() if s.name == "pft.solve"][-1]
    blocks = [s for s in tracing.spans() if s.root == root.id
              and s.name == "pft.loop.block"]
    assert len(blocks) == 4 == root.attrs["blocks"]
    assert "gap_us" not in blocks[0].attrs
    for b in blocks:
        assert b.attrs["device_us"] > 0.0
    for b in blocks[1:]:
        assert b.attrs["gap_us"] >= 0.0
    assert reader("block_gap_us")({}, {}) >= 0.0
    assert reader("boundary_host_us")({}, {}) > 0.0
    assert reader("kernel_library_s")({}, {}) is None or (
        reader("kernel_library_s")({}, {}) > 0.0)
