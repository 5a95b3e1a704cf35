"""CPU tests of the benchmark harness (run: ``python -m pytest slambench -q``).

The harness's lookup by name, its import boundary, the FLOP counter, the
idle-share union, the renderer copy against the port's dataset, and whole
runs at a small size on the CPU: sound, with each planted fault, and the
lower-precision control. The card-only test (``-m cuda``) reads the
control at a cell's own size.
"""

from __future__ import annotations

import argparse
import ast
import copy
import json
import os
import shutil

import numpy as np
import pytest
import torch

from slambench import check, control, faults, trace
from slambench import run as harness
from slambench.reference import online_pft

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
FORBIDDEN = {"jax", "jaxlib", "flax", "e2eslam_tpu", "bench", "tools"}


def _bench():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def _small(name, frames=5):
    """A cell at 64x96 and ``frames`` frames, one pool unit; the batch of
    sequences at 6 frames, its keyframes 0.12 m apart, so that its
    schedules differ in length (4, 3, 3, 4 events) and its masked commits
    run."""
    _, cell, conf = harness.load_cell(name)
    conf = copy.deepcopy(conf)
    conf["config"]["DATA"]["height"], conf["config"]["DATA"]["width"] = 64, 96
    if int(cell["n_seq"]) > 1:
        frames = 6
        conf["config"]["DEMO"]["frame_threshold"] = 0.12
    return dict(cell, frames=frames, pool=1), conf


def _imports(path):
    with open(path) as f:
        tree = ast.parse(f.read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "import_module":
            if node.args and isinstance(node.args[0], ast.Constant):
                yield node.args[0].value


def test_every_entry_resolves_by_name():
    bench = _bench()
    configs = {c["name"] for c in bench["configs"]}
    for c in bench["configs"]:
        assert os.path.isfile(os.path.join(ROOT, c["file"]))
    for w in bench["workloads"]:
        _, cell, conf = harness.load_cell(w["name"])
        assert cell["name"] == w["name"] and cell["config"] == w["config"] in configs
        online_pft.check_supported(conf["config"])
        for name, mod in harness.per_layer_metrics(bench, w["name"]).items():
            assert mod.UNIT == next(m["unit"] for m in bench["per_layer"] if m["name"] == name)
            assert mod.LAYER == next(m["layer"] for m in bench["per_layer"]
                                     if m["name"] == name)


def test_a_cell_added_as_new_files_is_found(tmp_path):
    root = tmp_path / "checkout"
    shutil.copytree(os.path.join(ROOT, "slambench"), root / "slambench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = _bench()
    bench["workloads"].append({"name": "dummy-seq8", "config": "default",
                               "traffic": "dummy-seq8", "chips": 1, "why": "test"})
    bench["per_layer"].append({"name": "dummy.units", "unit": "units", "better": "higher",
                               "source": "program_counter", "layer": "program",
                               "moves": "steps_per_s", "workloads": ["dummy-seq8"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    cell = json.loads((root / "slambench/workloads/default-seq12.json").read_text())
    (root / "slambench/workloads/dummy-seq8.json").write_text(
        json.dumps(dict(cell, name="dummy-seq8", frames=8)))
    (root / "slambench/metrics/dummy.units.py").write_text(
        'LAYER = "program"\nUNIT = "units"\n\n\ndef read(summary):\n'
        '    return summary.get("units")\n')
    _, found, conf = harness.load_cell("dummy-seq8", root=str(root))
    assert found["frames"] == 8 and conf["name"] == "default"
    readers = harness.per_layer_metrics(bench, "dummy-seq8", root=str(root))
    assert "dummy.units" in readers and "knn.ms_per_step" not in readers
    assert "dummy.units" not in harness.per_layer_metrics(bench, "default-seq12", root=str(root))
    assert readers["dummy.units"].read({"units": 3}) == 3
    assert readers["dummy.units"].read({}) is None


def test_nothing_imports_jax_and_the_reference_nothing_of_the_program():
    for dirpath, _, files in os.walk(HERE):
        for f in files:
            if not f.endswith(".py"):
                continue
            path = os.path.join(dirpath, f)
            tops = {m.split(".")[0] for m in _imports(path)}
            assert not tops & FORBIDDEN, (path, tops & FORBIDDEN)
            if os.sep + "reference" + os.sep in path:
                assert "e2eslam_tpu_torch" not in tops, path
                assert not any(m.startswith("slambench") for m in _imports(path)), path


def test_flop_counter_on_the_indoor_resnet18():
    assert online_pft.conv_macs(256, 320, 2) == pytest.approx(10.664e9, abs=0.0005e9)
    shapes = online_pft.network_shapes()
    assert sum(k == "conv" for _, _, k in shapes) == 34  # 31 run: heads 1-3 do not
    assert online_pft.flops_per_event(256, 320) == pytest.approx(2 * 10 * 10.664e9, rel=1e-4)


def test_idle_share_counts_overlaps_once():
    busy = [(0.0, 4.0), (1.0, 2.0), (3.0, 6.0), (8.0, 9.0), (8.5, 8.7)]
    assert trace.union_length(busy) == pytest.approx(7.0)
    assert trace.gaps(busy, (0.0, 10.0)) == [(6.0, 8.0), (9.0, 10.0)]
    profile = {"device": [(s, e, "k") for s, e in busy],
               "ranges": [(0.0, 10.0, "slambench.run")],
               "host": [(5.5, 9.2, "aten::copy_")]}
    bd = trace.breakdown(profile, (0.0, 10.0))
    assert bd["busy_s"] == pytest.approx(7e-6) and bd["window_s"] == pytest.approx(1e-5)
    assert bd["idle_gaps"] == [["run/aten::copy_", pytest.approx(2e-6)],
                               ["run/python", pytest.approx(1e-6)]]


def test_renderer_copy_equals_the_ports_dataset():
    from e2eslam_tpu_torch.data.synthetic import SyntheticDataset
    from slambench import scene

    for trajectory in ("arc", "revisit"):
        ds = SyntheticDataset(seqlen=4, height=32, width=40, dilation=2, start=23,
                              total_frames=60, trajectory=trajectory)
        c, d, K, p, _ = ds[0]
        C, D, K2, P = scene.sequence(23, 4, 2, 32, 40, trajectory=trajectory)
        np.testing.assert_allclose(C.numpy() * 255.0, c, atol=2e-5)
        np.testing.assert_array_equal(D.numpy(), d)
        np.testing.assert_array_equal(K2.numpy(), K)
        np.testing.assert_array_equal(P.numpy(), p)


def test_seeded_weights_load_into_the_ports_network():
    from e2eslam_tpu_torch.models.depth_net import DispResNetIndoor

    from slambench.weights import seeded_weights

    w = seeded_weights(2**31 + 7, "cpu")
    DispResNetIndoor().load_state_dict(w)
    again = seeded_weights(2**31 + 7, "cpu")
    assert all(torch.equal(w[k], again[k]) for k in w)
    k = w["encoder.layer3.0.conv1.weight"]
    assert abs(float(k.std()) - (1.0 / (128 * 9)) ** 0.5) < 0.02 * (1.0 / (128 * 9)) ** 0.5


def _run(name, frames=5):
    cell, conf = _small(name, frames)
    args = argparse.Namespace(workload=name, seed=2**31 + 3, seconds=0.0, trace=0)
    return harness.run_cell(args, _bench(), cell, conf, torch.device("cpu"))


SMALL = ["default-seq12", "flagship-seq60", "flagship-fleet4"]


@pytest.mark.parametrize("name", SMALL)
def test_a_small_run_is_correct(name):
    res = _run(name)
    assert res["correct"], res["checks"]
    assert list(res)[-1] == "checks" and res["failed"] == 0
    assert res["attempted"] == int(harness.load_cell(name)[1]["n_seq"])
    assert set(res["metrics"]) == {"steps_per_s", "abs_rel", "setup_s"}


def _failed(numbers, cell):
    limits = check.limits_of(cell)
    return [n for n in check.COMPARED
            if limits.get(n) is not None and numbers.get(n, 0) > limits[n]]


def test_the_state_is_kept_before_each_last_event():
    cell, conf = _small("flagship-fleet4")
    r = control.readings(cell, conf, 2**31 + 3, torch.device("cpu"))["program"]
    assert r["events_followed"] == 3 + 3 and r["events_missing"] == 0


@pytest.mark.parametrize("name", SMALL)
def test_each_planted_fault_is_not_correct(name):
    cell, conf = _small(name)
    names = [f for f in faults.faults_for(cell) if f not in cell.get("not_caught", ())]
    r = control.readings(cell, conf, 2**31 + 3, torch.device("cpu"), fault_names=names)
    assert not _failed(r["program"], cell), r["program"]
    for fault in names:
        assert _failed(r[fault], cell), (fault, r[fault], cell["limits"])


@pytest.mark.parametrize("name,kind", [("default-seq12", "tf32"), ("flagship-seq60", "fp8"),
                                       ("flagship-fleet4", "fp8")])
def test_the_control_is_not_correct(name, kind):
    cell, conf = _small(name)
    r = control.readings(cell, conf, 2**31 + 3, torch.device("cpu"), control=kind)
    assert _failed(r["control"], cell), r["control"]


@pytest.mark.cuda
@pytest.mark.parametrize("name,kind", [("default-seq60", "tf32"), ("flagship-seq60", "fp8"),
                                       ("flagship-fleet4", "fp8"), ("default-seq12", "tf32")])
def test_the_control_fails_at_the_cells_size(name, kind):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: reads the control at the cell's own size")
    _, cell, conf = harness.load_cell(name)
    device = torch.device("cuda", 0)
    prepared = control.prepare(cell, conf, device)
    for seed in (2**31 + 11, 2**31 + 12, 2**31 + 13):
        r = control.readings(cell, conf, seed, device, control=kind, units=1,
                             prepared=prepared)
        assert _failed(r["control"], cell), r["control"]
        assert not _failed(r["program"], cell), r["program"]
