"""The port's multi-sequence runner (``parallel/``) against its own solo runs.

The JAX test's ragged data (``tests/test_parallel.py:182-236``: three
distinct 5-frame sequences at 64x64 and a frozen-tail copy of the third)
through ``ParallelAdaptation(n_seq=4)`` on the CPU: the four depth
networks run as one vmapped call, and a vmap fallback to a per-sample loop
(a warning) is an error here. Each sequence must match its solo
``OnlineAdaptation`` run (seeded ``SETTINGS.seed + i``, as the batched
runner seeds it): equal keyframes, abs_rel within 1e-3 (absolute) on the
first two keyframes (the batched convolution's rounding, amplified by
Adam's normalised steps; later keyframes drift further, as the JAX test
notes), map points within 2%. The config draws no random numbers
(auto-masking, min-reprojection and sparse supervision off).

Also: the program (``dispatch="whole"``, eager on the CPU) and the
per-event loop give equal results where no seed threads between keyframes,
and ``auto`` picks between them as the JAX runner does; a finished
sequence's parameters, optimizer state and map stay as its last active
event left them (either dispatch); ``n_seq`` must be a
multiple of the mesh size, and a mesh larger than the process group
raises; a ``data`` axis of two gloo processes (one sequence each, run
unbatched) equals the one-process run to the same tolerances; one
``refine_step`` of the batched runner equals the solo engine's step in
loss (rtol 1e-5) and gradient (rtol 1e-4 of each tensor's largest entry);
a finished sequence's parameters and optimizer state are left as they
were by a step of the others.
"""

import torch_omp  # noqa: F401  (first: OpenMP's wait policy, before torch loads)

import copy
import functools
import warnings

import numpy as np
import pytest
import torch

from e2eslam_tpu_torch.config import default_config_path, load_yaml
from e2eslam_tpu_torch.data.pipeline import ArrayDataset, load_batch
from e2eslam_tpu_torch.data.synthetic import SyntheticDataset
from e2eslam_tpu_torch.engine.adaptation import OnlineAdaptation
from e2eslam_tpu_torch.models.depth_net import make_depth_model
from e2eslam_tpu_torch.parallel.adaptation import ParallelAdaptation
from e2eslam_tpu_torch.parallel.mesh import Mesh, ParallelRefinement, make_mesh
from torch_dist_worker import run_world

H = W = 64
L = 5


def _cfg():
    cfg = load_yaml(default_config_path())
    cfg.DATA.name = "synthetic"
    cfg.DATA.height, cfg.DATA.width = H, W
    cfg.DEMO.sequence_length = L
    cfg.DEMO.frame_threshold = 0.01
    cfg.OPTIMIZATION.refinement_steps = 2
    cfg.LOSS.three3d_loss = True
    cfg.LOSS.three3d_texture_gate = 600.0
    cfg.DEBUG.print_metrics = False
    cfg.MODEL.map_capacity = L * H * W
    return cfg


@functools.lru_cache(maxsize=None)
def _ragged():
    """The JAX test's 3 distinct sequences + a frozen tail: per-sequence
    datasets and the stacked arrays read back through them."""
    ds = SyntheticDataset(seqlen=L, height=H, width=W, dilation=0, stride=2,
                          total_frames=3 * L + 4)
    items = [ds[i] for i in range(3)]
    c3, d3, p3 = (items[2][0] / 255.0).copy(), items[2][1].copy(), items[2][3].copy()
    c3[2:], d3[2:], p3[2:] = c3[1], d3[1], p3[1]
    seqs = [(it[0] / 255.0, it[1], it[2], it[3]) for it in items] + [(c3, d3, items[2][2], p3)]
    sets = [ArrayDataset(*s) for s in seqs]
    batches = [load_batch(s, [0]) for s in sets]
    return sets, tuple(np.concatenate([b[k] for b in batches]) for k in range(4))


def _batched(cfg, seqs, **kw):
    par = ParallelAdaptation(cfg, make_depth_model(cfg), map_capacity=L * H * W,
                             n_seq=seqs[0].shape[0], device="cpu")
    with warnings.catch_warnings():
        warnings.simplefilter("error")  # a vmap per-sample fallback warns
        return par.run(par.init_state(), seqs, threshold=float(cfg.DEMO.frame_threshold), **kw)


def _solo(cfg, dataset, i):
    c = copy.deepcopy(cfg)
    c.SETTINGS.seed = 1 + i
    runner = OnlineAdaptation(c, dataset=dataset, device="cpu", model=make_depth_model(cfg))
    runner.use_sequence_program = False  # the batched runner runs the loop per sequence
    return runner.run(verbose=False)


def _close(got, want):
    assert got["keyframes"] == want["keyframes"]
    a = np.asarray(got["per_pair_abs_rel"][:2])
    b = np.asarray([m["abs_rel"] for m in want["metrics"]][:2])
    np.testing.assert_allclose(a, b, rtol=0, atol=1e-3)
    assert abs(got["map_points"] - want["map_points"]) <= 0.02 * want["map_points"]


def test_batched_sequences_match_their_solo_runs():
    cfg = _cfg()
    sets, seqs = _ragged()
    out = _batched(cfg, seqs)
    counts = [r["num_keyframes"] for r in out["per_sequence"]]
    assert counts[3] < counts[2], counts  # ragged: the frozen tail ends early
    assert out["num_events"] == max(counts)
    for i, s in enumerate(sets):
        _close(out["per_sequence"][i], _solo(cfg, s, i))
    means = [round(r["mean_abs_rel"], 6) for r in out["per_sequence"][:3]]
    assert len(set(means)) == 3, means  # distinct sequences adapt differently


def test_dispatch_modes_are_one_loop():
    """The three ``dispatch`` values on the CPU: ``whole`` (the program, its
    events eager here) and ``event`` (the per-event loop) give equal
    results where nothing threads a seed between keyframes (R = 1); ``auto``
    takes the program below 8 sequences. A config the program does not run
    (3-frame windows) makes ``whole`` raise and ``auto`` take the loop; an
    unknown value raises."""
    cfg = _cfg()
    cfg.OPTIMIZATION.refinement_steps = 1
    _, seqs = _ragged()
    two = tuple(x[2:] for x in seqs)
    runs = [_batched(cfg, two, dispatch=d) for d in ("whole", "event", "auto")]
    assert [r["dispatch"] for r in runs] == ["whole", "event", "whole"]
    assert runs[0]["graphs"] == 0  # eager on the CPU
    for r in runs[1:]:
        for a, b in zip(r["per_sequence"], runs[0]["per_sequence"]):
            assert a["keyframes"] == b["keyframes"]
            assert a["per_pair_abs_rel"] == b["per_pair_abs_rel"]
            assert a["map_points"] == b["map_points"]
            np.testing.assert_array_equal(a["est_poses"], b["est_poses"])
    with pytest.raises(ValueError, match="dispatch"):
        _batched(cfg, two, dispatch="program")
    cfg.DEMO.sequence_length_refinement = 3
    with pytest.raises(ValueError, match="F != 2 windows"):
        _batched(cfg, two, dispatch="whole")
    assert _batched(cfg, two)["dispatch"] == "event"


@pytest.mark.parametrize("dispatch", ["whole", "event"])
def test_finished_sequence_keeps_its_last_active_state(dispatch):
    """The masked commit: the sequence that runs out of keyframes first
    ends the run with its parameters, optimizer state and map equal to the
    bit to those after its last active event, though the others go on
    stepping (and, in the program, it goes on computing)."""
    cfg = _cfg()
    _, seqs = _ragged()
    two = tuple(x[2:] for x in seqs)
    par = ParallelAdaptation(cfg, make_depth_model(cfg), map_capacity=L * H * W, n_seq=2,
                             device="cpu")
    state = par.init_state()
    snap, events = {}, [0]
    fuse = par.par.fuse_pair

    def watched(*args, **kw):
        maps, est = fuse(*args, **kw)
        if events[0] == snap.get("last"):
            opt = state.optimizer
            snap["params"] = {k: v[1].clone() for k, v in state.params.items()}
            snap["opt"] = {(k, key): t[1].clone() for k, v in state.params.items()
                           for key, t in opt.state.get(v, {}).items()
                           if torch.is_tensor(t) and t.shape == v.shape}
            n = int(maps[1].count)
            snap["map"] = (n, maps[1].data[:n].clone())
        events[0] += 1
        return maps, est

    from e2eslam_tpu_torch.engine.adaptation import keyframe_schedule

    counts = [len(keyframe_schedule(p, 0.01)) for p in two[3]]
    assert counts[1] < counts[0], counts
    snap["last"] = counts[1] - 1
    par.par.fuse_pair = watched
    out = par.run(state, two, threshold=0.01, dispatch=dispatch)
    assert out["dispatch"] == dispatch and events[0] == counts[0]
    moved = 0
    for k, v in state.params.items():
        assert torch.equal(v[1], snap["params"][k]), k
        moved += int(not torch.equal(v[0], v[1]))
    assert moved > 0 and snap["opt"]
    for (k, key), t in snap["opt"].items():
        assert torch.equal(state.optimizer.state[state.params[k]][key][1], t), (k, key)
    n, rows = snap["map"]
    assert out["per_sequence"][1]["map_points"] == n
    assert torch.equal(out["maps"][1].data[:n], rows)


def test_mesh_size_guards():
    cfg = _cfg()
    model = make_depth_model(cfg)
    two = Mesh(size=2, rank=0, group=None, device=torch.device("cpu"))
    with pytest.raises(ValueError, match="multiple"):
        ParallelAdaptation(cfg, model, map_capacity=L * H * W, mesh=two, n_seq=3)
    with pytest.raises(ValueError, match="only 1 device"):
        make_mesh(2, device="cpu")
    assert make_mesh(device="cpu").size == 1
    par = ParallelAdaptation(cfg, model, map_capacity=L * H * W, mesh=two, n_seq=4)
    assert par.n == 4 and par.par.n_local == 2


def test_data_axis_over_gloo_equals_one_process(tmp_path):
    cfg = _cfg()
    _, seqs = _ragged()
    two = tuple(x[1:3] for x in seqs)
    want = _batched(cfg, two)
    ranks = run_world("adapt", 2, {"config": cfg, "capacity": L * H * W, "n_seq": 2,
                                   "sequences": two, "threshold": 0.01}, tmp_path)
    for r in ranks:
        assert r["mesh_size"] == 2 and r["num_events"] == want["num_events"]
        assert len(r["per_sequence"]) == 2
        for got, ref in zip(r["per_sequence"], want["per_sequence"]):
            assert got["keyframes"] == ref["keyframes"]
            np.testing.assert_allclose(got["per_pair_abs_rel"][:2], ref["per_pair_abs_rel"][:2],
                                       rtol=0, atol=1e-3)
            assert abs(got["map_points"] - ref["map_points"]) <= 0.02 * ref["map_points"]
    # each rank kept its own sequence's map
    assert [r["map_points"][0] for r in ranks] == [s["map_points"] for s in
                                                   ranks[0]["per_sequence"]]


def test_refine_step_equals_solo_step_and_masks_finished():
    """One batched PFT step on a 2-frame window (an empty map: no 3D loss)
    against each sequence's solo engine step; then a step with sequence 1
    inactive leaves its parameters and Adam moments as they were."""
    cfg = _cfg()
    _, seqs = _ragged()
    colors, depths, K, poses = (torch.from_numpy(x) for x in seqs)
    pr = ParallelRefinement(cfg, make_depth_model(cfg), map_capacity=L * H * W, n_seq=4,
                            device="cpu")
    state = pr.init_state()
    from e2eslam_tpu_torch.engine.refine import PairBatch, RefinementEngine

    pairs = PairBatch(colors=colors[:, :2], gt_depths=depths[:, :2], intrinsics=K,
                      poses=poses[:, :2])
    maps = pr.init_maps()
    metrics, _ = pr.refine_step(state, pairs, maps)
    grads = {k: v.grad.clone() for k, v in state.params.items() if v.grad is not None}
    for i in range(4):
        eng = RefinementEngine(cfg, make_depth_model(cfg), map_capacity=L * H * W,
                               device=torch.device("cpu"))
        pair = PairBatch(colors=colors[i, :2], gt_depths=depths[i, :2], intrinsics=K[i],
                         poses=poses[i, :2])
        m, _ = eng.refine_step(pair, eng.make_empty_map())
        np.testing.assert_allclose(float(metrics[i]["total_loss"]), float(m["total_loss"]),
                                   rtol=1e-5)
        for name, p in eng.model.named_parameters():
            if p.grad is None:
                continue
            scale = float(p.grad.abs().max())
            np.testing.assert_allclose(grads[name][i].numpy(), p.grad.numpy(), rtol=0,
                                       atol=1e-4 * scale + 1e-12)
    before = {k: v[1].clone() for k, v in state.params.items()}
    moments = {id(p): {k: t[1].clone() for k, t in state.optimizer.state[p].items()
                       if torch.is_tensor(t) and t.shape == p.shape}
               for p in state.params.values() if p in state.optimizer.state}
    pr.refine_step(state, pairs, maps, active=[True, False, True, True], step=1)
    moved = 0
    for k, v in state.params.items():
        assert torch.equal(v[1], before[k]), k
        moved += int(not torch.equal(v[0], v[1]))
        for key, t in moments.get(id(v), {}).items():
            assert torch.equal(state.optimizer.state[v][key][1], t), (k, key)
    assert moved > 0
