"""Tests of the ``monodepth2-r50-seq60`` cell (run: ``python -m pytest
slambench -q``; the card's: ``python -m pytest slambench -m cuda``).

On the CPU: the cell resolves by name and its configuration passes its
reference's ``check_supported``; the seeded weights load into the runner's
template; a small run (64x96) is correct, each planted fault and the TF32
control are not; the readers of the network's phases on a synthetic trace.
On the card, at the cell's own size: the check catches the TF32 control and
ResNet v1's stride (``v1_stride``, planted here).
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import copy
import json
import os

import pytest
import torch
import torch.nn.functional as F

from slambench import check, control, faults, traffic
from slambench import run as harness
from slambench.reference import monodepth2_pft

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
CELL = "monodepth2-r50-seq60"
SEED = 2**31 + 3


def _bench():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


@contextlib.contextmanager
def v1_stride():
    """The port's bottleneck with ResNet v1's stride, on its 1x1 ``conv1``
    and not (as torchvision's v1.5 and the reference) on its 3x3 ``conv2``."""
    from e2eslam_tpu_torch.models import resnet

    orig = resnet.Bottleneck.forward

    def forward(self, x):
        stride = self.conv2.stride
        out = self.relu(self.bn1(F.conv2d(x, self.conv1.weight, None, stride)))
        out = self.relu(self.bn2(F.conv2d(out, self.conv2.weight, None, 1, 1)))
        out = self.bn3(self.conv3(out))
        identity = x if self.downsample is None else self.downsample(x)
        return self.relu(out + identity)

    resnet.Bottleneck.forward = forward
    try:
        yield
    finally:
        resnet.Bottleneck.forward = orig


def _small():
    _, cell, conf = harness.load_cell(CELL)
    conf = copy.deepcopy(conf)
    conf["config"]["DATA"]["height"], conf["config"]["DATA"]["width"] = 64, 96
    return dict(cell, frames=5, pool=1), conf


def _failed(numbers, cell):
    limits = check.limits_of(cell)
    return [n for n in check.COMPARED
            if limits.get(n) is not None and numbers.get(n, 0) > limits[n]]


def _numbers(conf, prepared, units, refs):
    pool, weights, _ = prepared
    out = check.gaps([(x["pool_unit"], x["sequences"]) for x in units], refs)
    out.update(check.event_check(conf, pool, units))
    out["unmoved_leaves"] = check.unmoved(weights, units, refs)
    return out


def test_the_cell_resolves_and_its_weights_load():
    from e2eslam_tpu_torch.models.depth_net import MonodepthNet

    bench = _bench()
    _, cell, conf = harness.load_cell(CELL)
    entry = next(w for w in bench["workloads"] if w["name"] == CELL)
    assert entry["config"] == cell["config"] == conf["name"] == "monodepth2-r50"
    assert entry["chips"] == 1 and conf["reduced"] == []
    assert check.reference_module(conf) is monodepth2_pft
    monodepth2_pft.check_supported(conf["config"])
    readers = harness.per_layer_metrics(bench, CELL)
    assert {"cnn.encoder_ms_per_step", "cnn.decoder_ms_per_step", "mfu",
            "cnn.conv_ms_per_step"} <= set(readers)
    assert harness.flops_per_step(conf, harness.unit_config(conf, cell)) == pytest.approx(
        1.4701e11, rel=1e-4)  # 2 x 22.05e9 x 10 / 3 at 320x256
    small, conf = _small()
    weights = harness.network_weights(small, conf, "cpu")
    runner = harness.Runner(small, conf, [], weights, torch.device("cpu"))
    assert type(runner.template) is MonodepthNet
    assert runner.template.encoder.layer4[2].conv3.out_channels == 2048
    assert set(runner.template.state_dict()) == set(weights)


def test_a_small_run_is_correct():
    cell, conf = _small()
    args = argparse.Namespace(workload=CELL, seed=SEED, seconds=0.0, trace=0)
    res = harness.run_cell(args, _bench(), cell, conf, torch.device("cpu"))
    assert res["correct"], res["checks"]
    assert res["failed"] == 0 and res["attempted"] == 1


def test_each_planted_fault_and_the_control_are_not_correct():
    cell, conf = _small()
    names = [f for f in faults.faults_for(cell) if f not in cell.get("not_caught", ())]
    r = control.readings(cell, conf, SEED, torch.device("cpu"), control="tf32",
                         fault_names=names)
    assert not _failed(r["program"], cell), r["program"]
    for fault in names + ["control"]:
        assert _failed(r[fault], cell), (fault, r[fault], cell["limits"])


def test_the_readers_of_the_networks_phases(monkeypatch):
    """Two replayed events of one step: encoder 2 + encoder_grad 5 and
    decoder 1 + decoder_grad 3 ms an event; the fleet's phases read
    nothing."""
    from e2eslam_tpu_torch.utils import tracing

    log = collections.deque(maxlen=64)
    monkeypatch.setattr(tracing, "TRACES", log)
    readers = harness.per_layer_metrics(_bench(), CELL)
    phases = tracing.phase_names(1, tracing.NETWORK_STEP_PHASES)
    row = [0.5, 1.0, 2.0, 1.0, 4.0, 0.5, 3.0, 5.0, 0.7, 0.2, 3.5, 0.3]
    log.append({"phases": phases, "event_phase_ms": [row, row, row],
                "replayed": [False, True, True], "span_s": {}})
    assert readers["cnn.encoder_ms_per_step"].read({"units": 1}) == pytest.approx(7.0)
    assert readers["cnn.decoder_ms_per_step"].read({"units": 1}) == pytest.approx(4.0)
    log.append({"phases": tracing.phase_names(1), "event_phase_ms": [row[:9]],
                "replayed": [True], "span_s": {}})
    assert readers["cnn.encoder_ms_per_step"].read({"units": 1}) is None
    assert readers["cnn.decoder_ms_per_step"].read({"units": 1}) is None


@pytest.mark.cuda
def test_the_check_catches_tf32_and_v1_stride_at_the_cells_size():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: reads the check at the cell's own size")
    _, cell, conf = harness.load_cell(CELL)
    device = torch.device("cuda", 0)
    prepared = control.prepare(cell, conf, device)
    pool, weights, runner = prepared
    for seed in (2**31 + 11, 2**31 + 12):
        r = control.readings(cell, conf, seed, device, control="tf32", units=1,
                             prepared=prepared)
        assert _failed(r["control"], cell), r["control"]
        assert not _failed(r["program"], cell), r["program"]
        order = traffic.order(cell, seed)[:1]
        with v1_stride():
            units = [runner.unit(u, keep=True) for u in order]
        v1 = _numbers(conf, prepared, units, check.first_events(conf, pool, weights, set(order)))
        assert _failed(v1, cell), v1
