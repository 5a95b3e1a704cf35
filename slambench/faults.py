"""Faults planted under the program's timed path, for the output check's
own tests (``test_slambench_harness.py``) and ``control.py --faults``.

Each is a context manager that patches one function of the port where the
fault would arise, and restores it:

  * ``state_unchanged``: the optimizer's step returns the parameters as
    they were;
  * ``half_batch``: the photometric loss keeps the upper half of the
    target's pixels, its mean taken over them;
  * ``answer_altered``: the map rows fusion writes, the system's answer,
    hold their points 5% off (world coordinates scaled by 1.05);
  * ``association_shifted``: the 3D loss's association (the exact nearest
    neighbour, or the index image's slot) takes the map row after the one
    it found;
  * ``merges_nothing``: fusion merges no pixel into the map (its distance
    gate below 0), so every valid pixel is appended;
  * ``rows_swapped`` (several sequences): each sequence's network runs with
    the weights of the sequence before it, and its gradient reaches them;
  * ``commit_unmasked`` (several sequences): the optimizer's step is
    committed to every sequence, also to those whose schedule has ended.

A run on one card has no exchange between cards to leave out. A cell's
``not_caught`` (``workloads/<cell>.json``) names the faults its check does
not catch at the cell's size (``PERF.md`` gives the readings).
"""

from __future__ import annotations

import contextlib
import types

FAULTS = ("state_unchanged", "half_batch", "answer_altered", "association_shifted",
          "merges_nothing")
BATCH_FAULTS = ("rows_swapped", "commit_unmasked")


def faults_for(cell) -> tuple:
    """The faults a cell can have: the batch faults need several sequences."""
    return FAULTS + (BATCH_FAULTS if int(cell["n_seq"]) > 1 else ())


@contextlib.contextmanager
def _patch(obj, name, make):
    orig = getattr(obj, name)
    setattr(obj, name, make(orig))
    try:
        yield
    finally:
        setattr(obj, name, orig)


def _shifted(idx, rows: int):
    return (idx + 1).clamp(max=rows - 1)


def planted(name: str):
    import torch

    from e2eslam_tpu_torch.engine import refine

    if name == "state_unchanged":
        return _patch(torch.optim.Adam, "step", lambda orig: lambda self, *a, **k: None)
    if name == "half_batch":
        def half(orig):
            def f(pred, target):
                m = orig(pred, target)
                return m[:, : m.shape[1] // 2]
            return f
        return _patch(refine, "photometric_loss", half)
    if name == "answer_altered":
        from e2eslam_tpu_torch.slam import fusion

        def altered(orig):
            return lambda points, *a: orig(points * 1.05, *a)
        return _patch(fusion, "pack_rows", altered)
    if name == "association_shifted":
        stack = contextlib.ExitStack()

        def brute(orig):
            def f(gt_points, *a, **k):
                loss, idx = orig(gt_points, *a, **k)
                return loss, _shifted(idx, gt_points.shape[0])
            return f

        def index(orig):
            def f(state, *a, **k):
                idx, found = orig(state, *a, **k)
                return _shifted(idx, state.data.shape[0]), found
            return f
        stack.enter_context(_patch(refine, "knn_points_loss", brute))
        stack.enter_context(_patch(refine, "index_nn", index))
        return stack
    if name == "merges_nothing":
        from e2eslam_tpu_torch.slam import slam

        stack = contextlib.ExitStack()

        def no_merge(orig):
            return lambda state, frame, **k: orig(state, frame, **dict(k, dist_th=-1.0))
        stack.enter_context(_patch(slam, "pointfusion_step", no_merge))
        stack.enter_context(_patch(slam, "pointfusion_step_index", no_merge))
        return stack
    if name == "rows_swapped":
        from e2eslam_tpu_torch.parallel.mesh import ParallelRefinement

        def swapped(orig):
            def f(self, state, x):
                rolled = {k: v.roll(1, 0) for k, v in state.params.items()}
                return orig(self, types.SimpleNamespace(params=rolled, buffers=state.buffers), x)
            return f
        return _patch(ParallelRefinement, "forward", swapped)
    if name == "commit_unmasked":
        from e2eslam_tpu_torch.parallel import mesh

        return _patch(mesh, "commit_rows", lambda orig: lambda saved, mask: None)
    raise ValueError(f"unknown fault {name!r}")
