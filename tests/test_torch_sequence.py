"""The port's whole-sequence program (``RefinementEngine.process_sequence``)
against the JAX package's (``engine.process_sequence``,
e2eslam_tpu/engine/refine.py:1277-1405), on the CPU, where the port runs
every event eagerly with the map's count as a device tensor.

Runs: 64x64, 6 frames (5 keyframe events), R = 2, the JAX runner's
weights carried over (``models/convert.py``), both runners through their
programs (``OnlineAdaptation.run`` with ``verbose=False``): the default
brute three3d, the flagship settings (index fusion and association) in
float32, the brute path with compaction every 2nd event (voxel and
projective passes), gradICP odometry, ``MODEL.active_window``, the SGD
optimizer and the observability outputs (``VIZ.log_gradients``,
``DEBUG.plot``: each event's gradient norms and debug images in the
programs' buffers; on the same key set through
``models/convert.py::torch_key``, event 0's norms within 2e-3 relative, as
tests/test_torch_observability.py holds one step's, event 1's within 2e-3
relative or 2e-5 of its largest norm, since the disparity head's bias
norm is a sum that cancels (7.9e-5, 1.06e-6 apart: 1.3%, every other
norm within 4.3e-4); the first two events' images within 1e-3).
Tolerances, as
for the runs of ``tests/test_torch_pft_runs.py``: equal keyframes; each
of the first two events' last-step metrics within 1e-3 relative; the map
count within max(4, count // 1000), the JAX
package's own tie allowance (tests/test_engine.py:506-508); equal
compaction events; estimated poses within 1e-4. The program reads no count
around a pass: each pass's recorded counts (on the device, read at the end)
equal the counts read on the host around the same pass.

The JAX search on the CPU is its XLA fallback, which ignores warm-start
seeds (e2eslam_tpu/ops/knn.py:890-904); the port's plain versions take
them, as its kernels and the Pallas kernels do, and a seed keeps a float32
near-tie (two map points within the score's rounding bound) that the
seedless search gives to the other point. Adam's normalised steps carry
those picks: with seeds the port's runs part from the JAX runs by up to
1% in abs_rel by the fourth event and 0.2% in map points (checked: with
the seeds dropped they agree to 3e-6 and one map point). So each config
runs the port twice: with its KNN's seeds dropped, the same function as
the JAX side's, held to every tolerance above; and as it ships (seeds
threaded through the steps and the events), held to the first two
events, the poses and the compaction events, and its map to 1%, the
tolerance of the runs of ``tests/test_torch_pft_runs.py``. The compaction
config's map and pass counts are held to 1% either way, as
``tests/test_torch_compact_runs.py`` holds them (a point on a voxel's edge
lands on either side by the packages' 1e-6 float noise).

Also: the dispatch rule (``sequence_program_blocker``) against the JAX
runner's (adaptation.py:191-195), and the count-carrying functions with a
device-tensor count against the same calls with an int count.
"""

import torch_omp  # noqa: F401  (first: OpenMP's wait policy, before torch loads)
from torch_omp import pinned_threads

import jax
import numpy as np
import pytest
import torch

from e2eslam_tpu.config import default_config_path as jax_default_path
from e2eslam_tpu.config import load_yaml as jax_load_yaml
from e2eslam_tpu.engine import adaptation as jax_adaptation
from e2eslam_tpu.slam import compact as jax_compact
from e2eslam_tpu_torch.config import default_config_path, load_yaml
from e2eslam_tpu_torch.engine import refine as refine_mod
from e2eslam_tpu_torch.engine.adaptation import sequence_program_blocker
from e2eslam_tpu_torch.losses import points as points_mod
from e2eslam_tpu_torch.models.convert import load_jax_params, torch_key
from e2eslam_tpu_torch.models.depth_net import make_depth_model

H, W = 64, 64
BASE = {"DATA.height": H, "DATA.width": W, "DEMO.sequence_length": 6,
        "DEMO.frame_threshold": 0.01, "OPTIMIZATION.refinement_steps": 2,
        "OPTIMIZATION.learning_rate": 1e-5}
FLAGSHIP_F32 = {  # bench.py::flagship_cfg's settings, the CNN in float32
    "MODEL.fusion_impl": "index", "LOSS.knn_impl": "index", "LOSS.three3d_query_stride": 1,
    "LOSS.three3d_align": "relative", "LOSS.three3d_dist_gate": 0.15,
    "LOSS.three3d_conf_weight": True, "LOSS.three3d_loss_weight": 0.1,
    "MODEL.index_search_radius": 0, "MODEL.index_levels": 2, "LOSS.index_assoc_levels": 1,
    "OPTIMIZATION.fused_update": True, "ABLATION.median_stride": 4}
RUNS = {"brute": {}, "index": FLAGSHIP_F32, "compact": {"MODEL.compact_period": 2},
        "compact_projective": {"MODEL.compact_period": 2, "MODEL.compact_mode": "projective"},
        "gradicp": {"MODEL.odom": "gradicp"},
        # The active window: fusion associates with the newest 6,000 rows
        # (about 1.5 frames at 64x64), its start following the device count.
        "window": {"MODEL.active_window": 6000},
        # The port's SGD (momentum 0.9, weight decay 1e-3 on every parameter),
        # at ten times BASE's rate: its events agree with JAX's to 1e-6. At
        # 1e-3 the first three agree to 4e-7 and a near-tie carried by the
        # larger steps moves the fifth by 0.15% and the map by 19 points.
        "sgd": {"OPTIMIZATION.optimizer": "SGD", "OPTIMIZATION.learning_rate": 1e-4},
        # The observability outputs, carried by both programs.
        "observed": {"VIZ.log_gradients": True, "DEBUG.plot": True, "DEBUG.plot_path": None}}


def _cfg(load, path, over):
    cfg = load(path)
    for k, v in {**BASE, **over}.items():
        sec, flag = k.split(".")
        cfg[sec][flag] = v
    return cfg


def run_both(over, monkeypatch):
    """The JAX runner's program and the port's on the same config and
    weights. Returns ({seeds: port run} with the KNN's warm-start seeds
    dropped and taken, the JAX run, the JAX side's compaction passes as
    (count before, count after), read through ``jax.debug.callback``).
    Each port run's ``host_counts`` holds its passes' counts read on the
    host around ``compact_now``."""
    events = []
    for name in ("compact_map", "compact_map_projective"):
        orig = getattr(jax_compact, name)

        def recorded(m, *a, _orig=orig, **kw):
            out = _orig(m, *a, **kw)
            jax.debug.callback(lambda b, c: events.append((int(b), int(c))), m.count, out.count)
            return out

        monkeypatch.setattr(jax_compact, name, recorded)
    jr = jax_adaptation.OnlineAdaptation(_cfg(jax_load_yaml, jax_default_path(), over))
    weights = jax.tree_util.tree_map(np.asarray, jax.device_get(
        (jr.state.params, jr.state.batch_stats)))
    want = jr.run(verbose=False)
    jax.effects_barrier()
    runs = {}
    for seeds in (False, True):
        with monkeypatch.context() as m:
            if not seeds:
                m.setattr(refine_mod, "knn", _seedless(refine_mod.knn))
                m.setattr(points_mod, "knn", _seedless(points_mod.knn))
            host = []
            now = refine_mod.RefinementEngine.compact_now

            def read(engine, ms, *a, _now=now, _host=host, **kw):
                before = int(ms.count)
                out = _now(engine, ms, *a, **kw)
                _host.append((before, int(out.count)))
                return out

            m.setattr(refine_mod.RefinementEngine, "compact_now", read)
            runs[seeds] = {**port_run(over, weights), "host_counts": host}
    return runs, want, events


def _seedless(knn):
    """``knn`` with its warm-start seeds dropped (the JAX CPU search's)."""
    def search(query, ref, nr=None, nq=None, init_idx=None, q_perm=None):
        return knn(query, ref, nr, nq)

    return search


def port_run(over, weights):
    from e2eslam_tpu_torch.engine.adaptation import OnlineAdaptation

    cfg = _cfg(load_yaml, default_config_path(), over)
    model = make_depth_model(cfg)
    load_jax_params(model, *weights)
    with pinned_threads(8):
        return OnlineAdaptation(cfg, device="cpu", model=model).run(verbose=False)


@pytest.mark.parametrize("name", sorted(RUNS))
def test_sequence_program_matches_jax(name, monkeypatch):
    runs, want, events = run_both(RUNS[name], monkeypatch)
    for seeds, got in runs.items():
        assert got["sequence_program"] and got["graphs"] == 0  # eager on the CPU
        assert got["keyframes"] == [int(k) for k in want["keyframes"]]
        assert len(got["keyframes"]) >= 4
        for k in range(2):
            a, b = got["metrics"][k], want["metrics"][k]
            for key in ("abs_rel", "total_loss", "photometric", "three3d", "rmse", "a1"):
                np.testing.assert_allclose(a[key], float(b[key]), rtol=1e-3, atol=1e-7,
                                           err_msg=f"{key}, event {k}, seeds {seeds}")
        assert got["metrics"][1]["three3d"] > 0
        period = RUNS[name].get("MODEL.compact_period")
        # Compaction: 1%, as tests/test_torch_compact_runs.py holds it (a
        # point on a voxel's edge lands by 1e-6 float noise).
        allowance = (max(4, want["map_points"] // 100) if seeds or period
                     else max(4, want["map_points"] // 1000))
        assert abs(got["map_points"] - want["map_points"]) <= allowance, seeds
        np.testing.assert_allclose(got["est_poses"], want["est_poses"], atol=1e-4)
        if period:
            expected = [k for k in range(len(got["keyframes"])) if (k + 1) % period == 0]
            assert [c["keyframe"] for c in got["compactions"]] == expected
            assert len(events) == len(expected)
            assert [(c["before"], c["after"]) for c in got["compactions"]] == \
                got["host_counts"]
            for c, (before, after) in zip(got["compactions"], events):
                assert c["after"] < c["before"]
                for mine, theirs in ((c["before"], before), (c["after"], after)):
                    assert abs(mine - theirs) <= allowance, (c, before, after, seeds)
        if name == "gradicp":
            assert np.abs(got["est_poses"] - got["gt_kf_poses"]).max() > 1e-6
        if name == "observed":
            for k, floor in ((0, 0.0), (1, 2e-5)):
                check_observed(got["metrics"][k], want["metrics"][k], floor,
                               f"event {k}, seeds {seeds}")


def check_observed(got, want, floor, where):
    """One event's gradient norms (the port's parameter names against the
    flax paths; within 2e-3 relative or ``floor`` of the largest norm) and
    debug images (within 1e-3) against the JAX program's."""
    norms = {torch_key(tuple(k.split("/")), "params"): float(v)
             for k, v in want["grad_norms"].items()}
    assert set(got["grad_norms"]) == set(norms), where
    atol = floor * max(norms.values())
    for key, w in norms.items():
        if w == 0.0:
            assert got["grad_norms"][key] == 0.0, (key, where)
        else:
            np.testing.assert_allclose(got["grad_norms"][key], w, rtol=2e-3, atol=atol,
                                       err_msg=f"{key}, {where}")
    assert set(got["debug_images"]) == set(want["debug_images"]), where
    for key, w in want["debug_images"].items():
        np.testing.assert_allclose(got["debug_images"][key], np.asarray(w), rtol=0, atol=1e-3,
                                   err_msg=f"{key}, {where}")


class _Taken(Exception):
    pass


def test_dispatch_rule_matches_jax(monkeypatch):
    """``sequence_program_blocker`` sends a run where the JAX runner sends
    it: the program by default, with the active window, with SGD and with
    the observability outputs; the per-keyframe loop when verbose, with
    3-frame windows, the voxel association, no refinement step or
    ``use_sequence_program`` off. The JAX runner is stopped at its first
    dispatch (its engine's ``process_sequence``, or the loop's first
    window)."""

    def program(*a, **kw):
        raise _Taken("program")

    def loop(*a, **kw):
        raise _Taken("loop")

    cases = {"default": ({}, False, True), "verbose": ({}, True, True),
             "F3": ({"DEMO.sequence_length_refinement": 3}, False, True),
             "voxel": ({"LOSS.knn_impl": "voxel"}, False, True),
             "R0": ({"OPTIMIZATION.refinement_steps": 0}, False, True),
             "off": ({}, False, False),
             "window": ({"MODEL.active_window": 4096}, False, True),
             "SGD": ({"OPTIMIZATION.optimizer": "SGD"}, False, True),
             "log_gradients": ({"VIZ.log_gradients": True}, False, True),
             "tensorboard": ({"VIZ.tensorboard": True}, False, True),
             "plot": ({"DEBUG.plot": True}, False, True)}
    monkeypatch.setattr(jax_adaptation, "PairBatch", loop)
    for name, (over, verbose, use) in cases.items():
        jr = jax_adaptation.OnlineAdaptation(_cfg(jax_load_yaml, jax_default_path(), over))
        jr.use_sequence_program = use
        jr.engine.process_sequence = program
        with pytest.raises(_Taken) as taken:
            jr.run(verbose=verbose)
        why = sequence_program_blocker(_cfg(load_yaml, default_config_path(), over),
                                       verbose=verbose, use_sequence_program=use)
        assert (why is None) == (str(taken.value) == "program"), (name, why)
    # The active window, every optimizer, the chamfer and compaction take
    # the program.
    for over in ({"OPTIMIZATION.optimizer": "RMSprop"}, {"OPTIMIZATION.optimizer": "Adagrad"},
                 {"OPTIMIZATION.optimizer": "SGD"}, {"MODEL.active_window": 4096},
                 {"LOSS.chamfer_distance": True}, {"MODEL.compact_period": 4}):
        cfg = _cfg(load_yaml, default_config_path(), over)
        assert sequence_program_blocker(cfg, verbose=False) is None, over


# --------------------------------------------------------------------------
# a device-tensor count against an int count, on the same inputs
# --------------------------------------------------------------------------
def _t(n):
    return torch.tensor(n, dtype=torch.int64)


def _cloud(rng, n, spread=2.0):
    return torch.from_numpy(rng.uniform(-spread, spread, (n, 3)).astype(np.float32))


@pytest.mark.parametrize("route", ["resident", "dense", "cand"])
def test_knn_takes_a_tensor_count(route, monkeypatch):
    """The dispatcher through each plain version (resident: the ref set
    fits; dense: cold past the resident limit; cand: warm past it) gives the
    same distances and indices for tensor counts as for int ones."""
    from e2eslam_tpu_torch.ops import knn as K

    monkeypatch.setattr(K, "RES_MAX_ROWS", 4096)
    rng = np.random.default_rng(5)
    ref = _cloud(rng, 3000 if route == "resident" else 9000)
    q = ref[rng.integers(0, 2000, 700)] + 0.01 * _cloud(rng, 700)
    nr, nq = 2000 if route == "resident" else 7000, 650
    init = (torch.from_numpy(rng.integers(-1, nr, 700)) if route == "cand" else None)
    a = K.knn(q, ref, nr, nq, init_idx=init)
    b = K.knn(q, ref, _t(nr), _t(nq), init_idx=init)
    assert torch.equal(a[0][:nq], b[0][:nq]) and torch.equal(a[1][:nq], b[1][:nq])
    assert int(b[1][:nq].max()) < nr


def _frame(rng, h=16, w=20, z=2.0, pose=None):
    from e2eslam_tpu_torch.slam.rgbd import build_frame

    depth = torch.from_numpy((z + 0.05 * rng.random((h, w, 1))).astype(np.float32))
    color = torch.from_numpy(rng.random((h, w, 3)).astype(np.float32))
    K_ = torch.tensor([[20.0, 0, w / 2, 0], [0, 20.0, h / 2, 0], [0, 0, 1, 0], [0, 0, 0, 1]])
    return build_frame(color, depth, K_, torch.eye(4) if pose is None else pose)


@pytest.mark.parametrize("impl", ["scatter", "index"])
def test_fusion_keeps_a_tensor_count(impl):
    """Three fusions (scatter or two-level index fusion, level 2 every 2nd
    keyframe) from an int count and from a tensor count: equal buffers,
    index images and counts, the tensor count staying a 0-d tensor."""
    from e2eslam_tpu_torch.slam.fusion import pointfusion_step, pointfusion_step_index
    from e2eslam_tpu_torch.slam.pointclouds import empty_map, on_device

    rng = np.random.default_rng(7)
    frames = [_frame(rng) for _ in range(3)]
    states = []
    for dev_count in (False, True):
        m = empty_map(3 * 16 * 20 - 100, index_hw=16 * 20 if impl == "index" else None,
                      index_levels=2)
        m = on_device(m) if dev_count else m
        for f in frames:
            m = (pointfusion_step_index(m, f, level2_period=2) if impl == "index"
                 else pointfusion_step(m, f))
        states.append(m)
    a, b = states
    assert isinstance(b.count, torch.Tensor) and b.count.ndim == 0
    assert int(b.count) == a.count > 16 * 20
    assert torch.equal(a.data, b.data)
    if impl == "index":
        assert isinstance(b.kf_counter, torch.Tensor) and int(b.kf_counter) == a.kf_counter
        for name in ("index_image", "index_image2", "index_pose", "index_pose2"):
            assert torch.equal(getattr(a, name), getattr(b, name)), name


@pytest.mark.parametrize("window", [500, 700, 4000])
def test_window_view_takes_a_tensor_count(window):
    """The active window (``slam/fusion.py::_window_view``) from a device
    count: the start ``clip(count - W, 0, N - W)`` and the rows gathered
    equal the host count's slice; three scatter fusions and
    ``projective_nn`` within the window give equal buffers, counts and
    neighbours from an int and a tensor count."""
    from e2eslam_tpu_torch.slam.fusion import _window_view, pointfusion_step, projective_nn
    from e2eslam_tpu_torch.slam.pointclouds import MapState, empty_map, on_device

    rng = np.random.default_rng(13)
    data = torch.from_numpy(rng.normal(size=(900, 16)).astype(np.float32))
    for count in (0, 300, 850, 900):
        s0, rows0, a = _window_view(MapState(data=data, count=count), min(window, 900))
        s1, rows1, b = _window_view(MapState(data=data, count=_t(count)), min(window, 900))
        assert rows0 is None and isinstance(s1, torch.Tensor) and int(s1) == s0
        assert torch.equal(rows1, torch.arange(s0, s0 + a.data.shape[0]))
        assert torch.equal(a.data, b.data) and int(b.count) == a.count
    frames = [_frame(rng, pose=None) for _ in range(3)]
    states = []
    for dev_count in (False, True):
        m = empty_map(3 * 16 * 20 - 50)
        m = on_device(m) if dev_count else m
        for f in frames:
            m = pointfusion_step(m, f, active_window=window)
        nn = projective_nn(m, frames[-1], active_window=window)
        states.append((m, nn))
    (a, nn_a), (b, nn_b) = states
    assert isinstance(b.count, torch.Tensor) and int(b.count) == a.count > 16 * 20
    assert torch.equal(a.data, b.data)
    assert torch.equal(nn_a[0], nn_b[0]) and torch.equal(nn_a[1], nn_b[1])


@pytest.mark.parametrize("impl", ["scatter", "index"])
def test_inactive_fusion_leaves_the_map(impl):
    """Fusion with ``active`` False (the multi-sequence program's masked
    commit) leaves the buffer, the count, the index images and the
    keyframe counter as they were; with ``active`` True it equals the
    unmasked fusion."""
    from e2eslam_tpu_torch.slam.fusion import pointfusion_step, pointfusion_step_index
    from e2eslam_tpu_torch.slam.pointclouds import empty_map, on_device

    rng = np.random.default_rng(17)
    frames = [_frame(rng) for _ in range(3)]

    def fuse(m, f, active=None):
        if impl == "index":
            return pointfusion_step_index(m, f, level2_period=2, active=active)
        return pointfusion_step(m, f, active_window=400, active=active)

    def fresh():
        m = on_device(empty_map(3 * 16 * 20, index_hw=16 * 20 if impl == "index" else None,
                                index_levels=2))
        for f in frames[:2]:
            m = fuse(m, f)
        return m

    names = ("count", "index_image", "index_pose", "index_image2", "index_pose2",
             "kf_counter")
    m = fresh()
    before = (m.data.clone(), {n: getattr(m, n) for n in names})
    out = fuse(m, frames[2], torch.tensor(False))
    assert torch.equal(out.data, before[0])
    for n in names:
        if before[1][n] is not None:
            assert torch.equal(getattr(out, n), before[1][n]), n
    a, b = fuse(fresh(), frames[2]), fuse(fresh(), frames[2], torch.tensor(True))
    assert int(a.count) == int(b.count) > int(before[1]["count"])
    assert torch.equal(a.data, b.data)


@pytest.mark.parametrize("mode", ["voxel", "projective"])
def test_append_and_compaction_keep_a_tensor_count(mode):
    """ICPSLAM's append and a compaction pass (voxel, or projective from
    the second frame's camera): equal rows and counts from an int and a
    tensor count (the tensor stays a tensor)."""
    from e2eslam_tpu_torch.slam.compact import compact_map, compact_map_projective
    from e2eslam_tpu_torch.slam.pointclouds import empty_map, on_device
    from e2eslam_tpu_torch.slam.slam import _append_frame

    rng = np.random.default_rng(9)
    frames = [_frame(rng), _frame(rng)]
    out = []
    for dev_count in (False, True):
        m = empty_map(2 * 16 * 20 - 50)
        m = on_device(m) if dev_count else m
        for f in frames:
            m = _append_frame(m, f)
        f = frames[-1]
        out.append((m, compact_map(m, voxel=0.05) if mode == "voxel" else
                    compact_map_projective(m, f.pose, f.intrinsics, height=16, width=20)))
    (a, ca), (b, cb) = out
    assert isinstance(b.count, torch.Tensor) and int(b.count) == a.count == 2 * 16 * 20 - 50
    assert torch.equal(a.data, b.data)
    assert isinstance(cb.count, torch.Tensor) and int(cb.count) == ca.count < a.count
    assert torch.equal(ca.data, cb.data)


def test_sort_tail_seed_and_gate_take_a_tensor_count():
    """``sort_map_points``, the engine's step-0 tail seed and the empty-map
    gate give for a tensor count what they give for the int."""
    from e2eslam_tpu_torch.engine.refine import RefinementEngine, empty_map_gate
    from e2eslam_tpu_torch.ops.spatial_sort import sort_map_points
    from e2eslam_tpu_torch.slam.pointclouds import MapState

    rng = np.random.default_rng(11)
    data = torch.zeros(5000, 16)
    data[:, :3] = _cloud(rng, 5000)
    for count in (0, 1234, 5000):
        a, b = sort_map_points(data[:, :3], count), sort_map_points(data[:, :3], _t(count))
        for x, y in zip(a, b):
            assert torch.equal(x, y)
        assert empty_map_gate(count) == float(empty_map_gate(_t(count))) == float(count > 0)
    cfg = _cfg(load_yaml, default_config_path(), {"LOSS.knn_seed_stride": 3})
    engine = RefinementEngine(cfg, make_depth_model(cfg), map_capacity=5000,
                              device=torch.device("cpu"))
    q = data[rng.integers(0, 3000, 500), :3] + 0.01
    for count in (1, 2999, 5000):
        index = sort_map_points(data[:, :3], count)
        a = engine._tail_seed(q, MapState(data=data, count=count), index)
        b = engine._tail_seed(q, MapState(data=data, count=_t(count)), index)
        assert torch.equal(a, b)


@pytest.mark.parametrize("kind", ["RMSprop", "Adagrad"])
def test_device_schedule_steps_as_the_host_scheduler(kind):
    """``DeviceSchedule`` (the learning rate a 0-d tensor recomputed from a
    device update count) moves the port's RMSprop and Adagrad as the host
    ``LambdaLR`` does, through a StepLR decay, and hands the count back."""
    from e2eslam_tpu_torch.engine.optim import DeviceSchedule, make_optimizer

    cfg = _cfg(load_yaml, default_config_path(), {
        "OPTIMIZATION.optimizer": kind, "OPTIMIZATION.schedular": "StepLR",
        "OPTIMIZATION.schedular_step_size": 3, "OPTIMIZATION.learning_rate": 1e-2})
    rng = np.random.default_rng(13)
    grads = [torch.from_numpy(rng.normal(size=(4, 5)).astype(np.float32)) for _ in range(8)]
    params = []
    for device_lr in (False, True):
        p = torch.nn.Parameter(torch.ones(4, 5))
        opt, sched = make_optimizer(cfg, [p])
        opt.step(), sched.step()  # one host update first
        ds = DeviceSchedule(cfg, opt, sched, torch.device("cpu")) if device_lr else None
        for g in grads:
            p.grad = g.clone()
            if ds is None:
                opt.step(), sched.step()
            else:
                ds.set_lr(), opt.step(), ds.stepped()
        if ds is not None:
            ds.exit()
        params.append((p.detach().clone(), sched.last_epoch, opt.param_groups[0]["lr"]))
    (a, na, la), (b, nb, lb) = params
    torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-7)
    assert na == nb == 9 and la == lb and isinstance(lb, float)


def test_lr_factor_is_the_host_schedule():
    from e2eslam_tpu_torch.engine.optim import _lr_lambda, lr_factor

    cfg = load_yaml(default_config_path()).OPTIMIZATION
    for kind, extra in (("StepLR", {"schedular_step_size": 100}),
                        ("MultiStepLR", {"schedular_milestones": [100, 200, 200]}),
                        ("ExponentialLR", {"schedular_gamma": 0.97}), ("none", {})):
        cfg.schedular = kind
        for k, v in extra.items():
            cfg[k] = v
        lam = _lr_lambda(cfg)
        counts = torch.arange(320)
        got = torch.stack([lr_factor(cfg, c) for c in counts])
        assert got.tolist() == [lam(int(c)) for c in counts], kind
