"""CPU tests of the benchmark harness (run: ``python -m pytest slambench -q``).

The harness's lookup by name, its import boundary, the FLOP counter, the
idle-share union, the renderer copy against the port's dataset, the
network, weights and FLOPs a configuration's reference module defines, and
whole runs at a small size on the CPU: sound, with each planted fault, and
the lower-precision control. The card-only test (``-m cuda``) reads the
control at a cell's own size.
"""

from __future__ import annotations

import argparse
import ast
import copy
import json
import math
import os
import shutil
import sys
import types

import numpy as np
import pytest
import torch

from slambench import check, control, faults, trace, traffic
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
        check.reference_module(conf).check_supported(conf["config"])
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

    w = seeded_weights(2**31 + 7, "cpu", online_pft.network_shapes())
    DispResNetIndoor().load_state_dict(w)
    again = seeded_weights(2**31 + 7, "cpu", online_pft.network_shapes())
    assert all(torch.equal(w[k], again[k]) for k in w)
    k = w["encoder.layer3.0.conv1.weight"]
    assert abs(float(k.std()) - (1.0 / (128 * 9)) ** 0.5) < 0.02 * (1.0 / (128 * 9)) ** 0.5


def _former_seeded_weights(seed, device):
    """``weights.py::seeded_weights`` as it drew every configuration's
    weights before the configuration's reference module named the tensors:
    always ``online_pft.network_shapes()``."""
    shapes = online_pft.network_shapes()
    convs = [(name, shape) for name, shape, kind in shapes if kind == "conv"]
    sizes = [math.prod(s) for _, s in convs]
    stds = torch.tensor([math.sqrt(1.0 / (s[1] * s[2] * s[3])) / 0.87962566103423978
                         for _, s in convs], device=device)
    gen = torch.Generator(device=device).manual_seed(int(seed) % (1 << 63))
    lo, hi = 0.5 * math.erfc(2.0 / math.sqrt(2.0)), 0.5 * math.erfc(-2.0 / math.sqrt(2.0))
    u = torch.rand(sum(sizes), generator=gen, device=device, dtype=torch.float64)
    x = math.sqrt(2.0) * torch.erfinv(2.0 * (lo + u * (hi - lo)) - 1.0)
    flat = (x * torch.repeat_interleave(stds.double(), torch.tensor(sizes, device=device))).float()
    out = {name: t.reshape(shape) for (name, shape), t in zip(convs, flat.split(sizes))}
    fill = {"bias": 0.0, "bn_weight": 1.0, "bn_bias": 0.0, "bn_mean": 0.0, "bn_var": 1.0}
    for name, shape, kind in shapes:
        if kind in fill:
            out[name] = torch.full(shape, fill[kind], device=device)
        elif kind == "bn_count":
            out[name] = torch.zeros((), dtype=torch.int64, device=device)
    return out


@pytest.mark.parametrize("name", ["default-seq12", "flagship-seq60"])
def test_the_configurations_weights_equal_the_former_draw(name):
    _, cell, conf = harness.load_cell(name)
    for seed in (int(cell["weights_seed"]), 2**31 + 5):
        new = harness.network_weights(dict(cell, weights_seed=seed), conf, "cpu")
        old = _former_seeded_weights(seed, "cpu")
        assert list(new) == list(old)
        for k in old:
            assert new[k].dtype == old[k].dtype and new[k].shape == old[k].shape, k
            assert torch.equal(new[k], old[k]), k
    cfg = harness.unit_config(conf, cell)
    assert harness.flops_per_step(conf, cfg) == online_pft.flops_per_event(256, 320, 2, 3) / 3


def _port_shapes(model):
    """(name, shape, kind) of a port network's state dict, kinds by module."""
    kinds = {}
    for name, m in model.named_modules():
        if isinstance(m, torch.nn.Conv2d):
            kinds.update({f"{name}.weight": "conv", f"{name}.bias": "bias"})
        elif isinstance(m, torch.nn.BatchNorm2d):
            kinds.update({f"{name}.{k}": v for k, v in (
                ("weight", "bn_weight"), ("bias", "bn_bias"), ("running_mean", "bn_mean"),
                ("running_var", "bn_var"), ("num_batches_tracked", "bn_count"))})
    return [(k, tuple(v.shape), kinds[k]) for k, v in model.state_dict().items()]


def _stub_reference(monkeypatch, name, shapes):
    """A reference module ``slambench.reference.<name>`` that holds
    ``shapes`` and counts 7 FLOPs a pixel, frame and pass."""
    stub = types.ModuleType(f"slambench.reference.{name}")
    stub.check_supported = lambda cfg: None
    stub.network_shapes = lambda: list(shapes)
    stub.flops_per_event = lambda h, w, frames=2, steps=3: 7.0 * h * w * frames * (3 * steps + 1)
    stub.keyframe_schedule = online_pft.keyframe_schedule
    monkeypatch.setitem(sys.modules, stub.__name__, stub)
    return stub


def _monodepth2_50(name="default-seq12"):
    _, cell, conf = harness.load_cell(name)
    conf = copy.deepcopy(conf)
    conf["config"]["MODEL"].update(depth_network="monodepth2", num_layers=50)
    return cell, conf


def test_a_configuration_names_its_own_network(monkeypatch):
    from e2eslam_tpu_torch.models.depth_net import MonodepthNet

    cell, conf = _monodepth2_50()
    with torch.device("meta"):
        shapes = _port_shapes(MonodepthNet(50, scales=(0,)))
    stub = _stub_reference(monkeypatch, "stub_monodepth2_50", shapes)
    conf["reference"] = "stub_monodepth2_50"
    weights = harness.network_weights(cell, conf, "cpu")
    assert {k: tuple(v.shape) for k, v in weights.items()} == {k: s for k, s, _ in shapes}
    assert len(shapes) > len(online_pft.network_shapes())
    cfg = harness.unit_config(conf, cell)
    assert harness.flops_per_step(conf, cfg) == stub.flops_per_event(256, 320, 2, 3) / 3
    cell = dict(cell, frames=5, pool=1)
    conf["config"]["DATA"].update(height=64, width=96)
    pool = traffic.render_pool(cell, conf["config"], torch.device("cpu"))
    runner = harness.Runner(cell, conf, pool, weights, torch.device("cpu"))
    assert type(runner.template) is MonodepthNet
    held = runner.template.state_dict()
    assert set(held) == set(weights)
    assert all(held[k].data_ptr() == weights[k].data_ptr() for k in weights)  # assigned
    out = runner.unit(0)  # the template runs through the program
    abs_rel = out["sequences"][0]["abs_rel"]
    assert out["events"] == len(abs_rel) == runner.counts[0][0] > 0
    assert np.all(np.isfinite(abs_rel))


@pytest.mark.parametrize("case", ["unknown_network", "indoor_shapes", "one_resized"])
def test_set_up_names_what_does_not_match(monkeypatch, case):
    from e2eslam_tpu_torch.models.depth_net import MonodepthNet

    cell, conf = _monodepth2_50()
    with torch.device("meta"):
        shapes = _port_shapes(MonodepthNet(50, scales=(0,)))
    if case == "unknown_network":
        conf["config"]["MODEL"]["depth_network"] = "dispnet"
        expected = ["'dispnet'"]
    elif case == "indoor_shapes":
        shapes = online_pft.network_shapes()
        expected = ["MonodepthNet", "missing (first 'encoder.layer1.0.conv3.weight')",
                    "unexpected (first 'decoder.11.conv.weight')"]
    else:
        k, s, kind = shapes[0]
        shapes = [(k, (s[0], s[1], 3, 3), kind)] + shapes[1:]
        expected = ["0 missing", "0 unexpected", "1 of another shape (first "
                    "'encoder.conv1.weight')"]
    _stub_reference(monkeypatch, "stub_mismatch", shapes)
    conf["reference"] = "stub_mismatch"
    weights = harness.network_weights(cell, conf, "cpu")
    with pytest.raises(ValueError) as err:
        harness.Runner(cell, conf, [], weights, torch.device("cpu"))
    for text in expected:
        assert text in str(err.value)


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
