"""The online runner's observability outputs against the JAX runner's
(``e2eslam_tpu/engine/adaptation.py:172-181``, :304-307, :454-478;
``e2eslam_tpu/apps/online_adaption.py:28-32``).

64x64, 6 frames (5 keyframes), R = 2, the default config with
``VIZ.log_gradients`` and ``DEBUG.plot``, the JAX runner's weights carried
over (``models/convert.py``). The JAX runner runs its per-keyframe loop
(the path that prints the ``[bucket]`` lines; on the CPU its search ignores
warm-start seeds, so it computes what its program computes) with
``SETTINGS.log_path``, ``DEBUG.plot_path`` and ``E2ESLAM_DEBUG_BUCKET``.
The port runs twice: through its CLI (``apps/online_adaption.py``, which
takes the whole-sequence program) with every output on (the scalar log, the
PNGs, ``VIZ.profile_dir``, ``VIZ.plot_final_step``), and through its
per-keyframe loop with the scalar log and ``E2ESLAM_DEBUG_BUCKET``.

  * the scalar log: as many records as the JAX runner's, the same keys once
    the ``grad_norm/`` keys are mapped to the flax paths
    (``models/convert.py::torch_key``), the first two keyframes' values
    within 1e-3 relative (the run tests' tolerance; a norm also within 2e-5
    of the record's largest norm, as tests/test_torch_sequence.py holds
    event 1's: a bias's norm is a sum that cancels), the rest finite;
  * the debug images: the same PNG names;
  * the trace: a file under ``VIZ.profile_dir`` that parses as JSON, holds
    an ``aten::`` convolution event and the program's spans, and is the
    result's ``profile_trace``; the result's ``trace`` holds every event's
    phase times;
  * the final map: ``{plot_path}/{name}_map.ply`` with min(map points,
    200,000) vertices, byte for byte the JAX export of the same map;
  * the ``[bucket]`` lines: one for each keyframe the JAX loop prints one
    for, with the same bucket.
"""

import torch_omp  # noqa: F401  (first: OpenMP's wait policy, before torch loads)
from torch_omp import pinned_threads

import contextlib
import io
import json
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from e2eslam_tpu.config import default_config_path as jax_default_path
from e2eslam_tpu.config import load_yaml as jax_load_yaml
from e2eslam_tpu.engine import adaptation as jax_adaptation
from e2eslam_tpu.slam.pointclouds import MapState as JaxMap
from e2eslam_tpu.viz.pointcloud_export import export_ply as jax_ply
from e2eslam_tpu_torch.apps import online_adaption
from e2eslam_tpu_torch.config import default_config_path, load_yaml
from e2eslam_tpu_torch.engine import adaptation
from e2eslam_tpu_torch.models.convert import load_jax_params, torch_key
from e2eslam_tpu_torch.models.depth_net import make_depth_model
from e2eslam_tpu_torch.utils import tracing

H = W = 64
NAME = "outputs"
BASE = {"DATA.height": H, "DATA.width": W, "DEMO.sequence_length": 6,
        "DEMO.frame_threshold": 0.01, "OPTIMIZATION.refinement_steps": 2,
        "OPTIMIZATION.learning_rate": 1e-5, "DEBUG.print_metrics": False,
        "SETTINGS.name": NAME, "VIZ.log_gradients": True, "DEBUG.plot": True}
BUCKET = re.compile(r"\[bucket\] kf=(\d+) known=(\d+) lag=(\d+) ub=(\d+) bucket=(\d+)")


def _cfg(load, path, over):
    cfg = load(path)
    for k, v in {**BASE, **over}.items():
        sec, flag = k.split(".")
        cfg[sec][flag] = v
    return cfg


@contextlib.contextmanager
def _bucket_lines(out):
    """``E2ESLAM_DEBUG_BUCKET`` set and stdout captured into ``out``."""
    buf = io.StringIO()
    before = os.environ.get("E2ESLAM_DEBUG_BUCKET")
    os.environ["E2ESLAM_DEBUG_BUCKET"] = "1"
    try:
        with contextlib.redirect_stdout(buf):
            yield
    finally:
        if before is None:
            del os.environ["E2ESLAM_DEBUG_BUCKET"]
        else:
            os.environ["E2ESLAM_DEBUG_BUCKET"] = before
        out.extend(tuple(map(int, m.groups())) for m in BUCKET.finditer(buf.getvalue()))


def _model(weights):
    cfg = _cfg(load_yaml, default_config_path(), {})
    model = make_depth_model(cfg)
    load_jax_params(model, *weights)
    return model


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("online_outputs")
    out = {"tmp": tmp, "jax_buckets": [], "loop_buckets": []}
    jr = jax_adaptation.OnlineAdaptation(_cfg(jax_load_yaml, jax_default_path(), {
        "SETTINGS.log_path": str(tmp / "jax_log"), "DEBUG.plot_path": str(tmp / "jax_png")}))
    jr.use_sequence_program = False
    weights = jax.tree_util.tree_map(np.asarray, jax.device_get(
        (jr.state.params, jr.state.batch_stats)))
    with _bucket_lines(out["jax_buckets"]):
        out["jax"] = jr.run(verbose=False)
    argv = ["--config_path", default_config_path(), "--name", NAME]
    for k, v in {**BASE, "SETTINGS.device": "cpu", "SETTINGS.log_path": tmp / "program_log",
                 "DEBUG.plot_path": tmp / "program_png", "VIZ.profile_dir": tmp / "trace",
                 "VIZ.plot_final_step": True}.items():
        if k != "SETTINGS.name":
            argv += ["--set", f"{k}={str(v).lower() if isinstance(v, bool) else v}"]
    with pytest.MonkeyPatch.context() as m, pinned_threads(8):
        model = _model(weights)
        m.setattr(adaptation, "make_depth_model", lambda cfg: model)
        out["program"] = online_adaption.main(argv)
    runner = adaptation.OnlineAdaptation(
        _cfg(load_yaml, default_config_path(), {"SETTINGS.log_path": str(tmp / "loop_log"),
                                                "DEBUG.plot_path": None}),
        device="cpu", model=_model(weights))
    runner.use_sequence_program = False
    with pinned_threads(8), _bucket_lines(out["loop_buckets"]):
        out["loop"] = runner.run(verbose=False)
    return out


def _records(log_dir):
    """The JSONL's lines grouped by step: {step: {key: value}}."""
    records = {}
    with open(os.path.join(log_dir, f"{NAME}.jsonl")) as f:
        for line in f:
            rec = json.loads(line)
            rec.pop("time")
            records.setdefault(rec.pop("step"), {}).update(rec)
    return records


def _flax_keys(record):
    """A JAX record with its ``grad_norm/`` keys mapped to the port's
    parameter names."""
    return {("grad_norm/" + torch_key(tuple(k[len("grad_norm/"):].split("/")), "params")
             if k.startswith("grad_norm/") else k): v for k, v in record.items()}


@pytest.mark.parametrize("path", ["program", "loop"])
def test_scalar_log_matches_jax(runs, path):
    assert runs["program"]["sequence_program"] and not runs["loop"]["sequence_program"]
    got, want = _records(runs["tmp"] / f"{path}_log"), _records(runs["tmp"] / "jax_log")
    assert sorted(got) == sorted(want) == list(range(len(runs["jax"]["keyframes"])))
    for step in want:
        theirs = _flax_keys(want[step])
        mine = got[step]
        assert set(mine) == set(theirs), step
        assert any(k.startswith("grad_norm/") for k in mine)
        assert all(np.isfinite(v) for v in mine.values()), step
        if step < 2:
            largest = max(v for k, v in theirs.items() if k.startswith("grad_norm/"))
            for key, w in theirs.items():
                atol = 2e-5 * largest if key.startswith("grad_norm/") else 1e-7
                np.testing.assert_allclose(mine[key], w, rtol=1e-3, atol=atol,
                                           err_msg=f"{key}, step {step}")


def test_debug_image_names_match_jax(runs):
    tmp = runs["tmp"]
    mine = sorted(n for n in os.listdir(tmp / "program_png") if n.endswith(".png"))
    assert mine == sorted(os.listdir(tmp / "jax_png"))
    assert {"kf000_synth.png", "kf000_photo_err.png", "kf000_depth.png"} <= set(mine)
    assert len(mine) == 3 * len(runs["jax"]["keyframes"])


def test_trace_file(runs):
    path = runs["program"]["profile_trace"]
    assert path and os.path.dirname(path) == str(runs["tmp"] / "trace")
    assert os.listdir(runs["tmp"] / "trace") == [os.path.basename(path)]
    with open(path) as f:
        trace = json.load(f)
    names = {e.get("name", "") for e in trace["traceEvents"]}
    assert any(n.startswith("aten::conv") for n in names)
    assert {"e2eslam.program.eager_event", "e2eslam.step.loss", "e2eslam.event.fusion"} <= names
    assert runs["loop"]["profile_trace"] is None
    # The program's phase timestamps: every event, P = 4 + 8R phases each
    # (the single-sequence step splits the network at its encoder).
    R, E = BASE["OPTIMIZATION.refinement_steps"], len(runs["program"]["keyframes"])
    phase_ms = np.asarray(runs["program"]["trace"]["event_phase_ms"])
    assert runs["program"]["trace"]["phases"] == tracing.phase_names(R, tracing.NETWORK_STEP_PHASES)
    assert len(runs["program"]["trace"]["phases"]) == 4 + 8 * R
    assert phase_ms.shape == (E, 4 + 8 * R) and np.isfinite(phase_ms).all()
    assert runs["loop"]["trace"] is None


def test_final_map_ply(runs, tmp_path):
    result = runs["program"]
    path = runs["tmp"] / "program_png" / f"{NAME}_map.ply"
    with open(path) as f:
        header = [next(f) for _ in range(10)]
    assert header[2] == f"element vertex {min(result['map_points'], 200000)}\n"
    m = result["map"]
    jax_ply(JaxMap(data=jnp.asarray(m.data.numpy()), count=jnp.int32(m.count)),
            str(tmp_path / "jax.ply"), max_points=200000)
    assert path.read_bytes() == (tmp_path / "jax.ply").read_bytes()


def test_bucket_lines_match_jax(runs):
    mine, theirs = runs["loop_buckets"], runs["jax_buckets"]
    assert [b[0] for b in mine] == [b[0] for b in theirs] == \
        list(range(1, len(runs["jax"]["keyframes"]) + 1))
    assert [b[4] for b in mine] == [b[4] for b in theirs]
