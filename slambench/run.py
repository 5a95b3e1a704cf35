"""The port's benchmark: online adaptation on one CUDA card.

    python3 slambench/run.py --workload CELL --seed N --seconds S --trace 0|1

``CELL`` names ``slambench/workloads/CELL.json`` (its configuration in
``slambench/configs/``, its traffic: frames, sequences per unit, pool,
trajectory; the limits of its output check). Set-up renders the cell's
pool of sequences on the card (``traffic.py``), makes the cell's seeded
weights on the card (``weights.py``) and runs one warm-up unit of the
cell's own shapes; the seed sets the order in which the window takes the
pool's units and which units keep their final state for the check. The
window then runs units back to back, each through the public entry point a
user calls, from the seeded weights, a fresh runner and a fresh map:
``OnlineAdaptation(cfg, dataset=..., model=...).run()`` (one sequence; the
whole-sequence program) or ``ParallelAdaptation(...).run(...,
dispatch="whole")`` (``n_seq`` sequences; the program over them). It closes
at the end of the first whole pass over the pool that ends after ``S``
seconds, so every window holds the same sequences the same number of
times. End-to-end metrics (``--trace 0``):
``steps_per_s`` (every refinement step of the window over its whole time),
``abs_rel`` (the mean over every keyframe of the window) and ``setup_s``
(process start to the window). With ``--trace 1`` the window is followed by
``trace_units`` units under ``torch.profiler`` and the sync-debug
warnings, and the per-layer metrics (``metrics/<name>.py``) are printed
instead, with the device's busy time and a breakdown.

A few units of the window, at positions drawn from the seed, keep the
program's state before and after each sequence's last keyframe event
(``record.py``: clones on the device, in stream order, no host read).
After the window (and the traced units) the peak memory is read, the
program's state freed, and the plain reference (``reference/``) follows
each pool sequence's first keyframe event from the same weights and
frames, and each kept last event from the program's state before it: its
steps with the 3D point loss against the whole map, Adam, and the fusion
of its frame into that map; every unit of the window is compared
(``check.py``). The last lines on standard error, and the result's last
key, give each compared number beside its limit. The result is the last
line of standard output, one JSON object.

Without a CUDA card, or with fewer cards than the cell asks for, it prints
no result and exits with 3. Nothing here imports JAX; the run fails if the
process holds it at the end.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import copy  # noqa: E402
import gc  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
import warnings  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
if sys.path and os.path.abspath(sys.path[0]) == HERE:
    sys.path[0] = ROOT
elif ROOT not in sys.path:
    sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402
import torch  # noqa: E402

from slambench import check, record, traffic  # noqa: E402
from slambench.reference.online_pft import keyframe_schedule  # noqa: E402
from slambench.weights import seeded_weights  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "e2eslam_tpu")


def load_json(*parts):
    with open(os.path.join(*parts)) as f:
        return json.load(f)


def load_cell(name: str, root: str = ROOT):
    """(benchmark, cell, configuration file) by name, under ``root``."""
    bench = load_json(root, "BENCHMARK.json")
    cell = load_json(root, "slambench", "workloads", f"{name}.json")
    conf = load_json(root, "slambench", "configs", f"{cell['config']}.json")
    return bench, cell, conf


def per_layer_metrics(bench, cell_name: str, root: str = ROOT):
    """The per-layer metrics of cell ``cell_name``: {name: reader module},
    each from ``slambench/metrics/<name>.py`` under ``root``, for every
    metric whose ``workloads`` in ``BENCHMARK.json`` lists the cell (every
    cell where it has none); a reader that finds nothing to read returns
    None."""
    out = {}
    for m in bench["per_layer"]:
        if cell_name not in m.get("workloads", (cell_name,)):
            continue
        path = os.path.join(root, "slambench", "metrics", f"{m['name']}.py")
        spec = importlib.util.spec_from_file_location(f"slambench_metric_{len(out)}", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        out[m["name"]] = mod
    return out


def unit_config(conf, cell):
    from e2eslam_tpu_torch.config import Config

    cfg = Config(copy.deepcopy(conf["config"]))
    cfg.DEMO.sequence_length = int(cell["frames"])
    return cfg


class SequenceData:
    """One sequence held in host memory, in the datasets' item layout
    (colors in 0..255), for ``OnlineAdaptation``'s ``dataset``."""

    def __init__(self, colors255, depths, K, poses):
        self._item = (colors255, depths, K, poses,
                      np.broadcast_to(np.eye(4, dtype=np.float32), poses.shape).copy())

    def __len__(self):
        return 1

    def __getitem__(self, i):
        return self._item


class Runner:
    """Runs units of the cell through the port's public entry points."""

    def __init__(self, cell, conf, pool, weights, device):
        from e2eslam_tpu_torch.models.depth_net import DispResNetIndoor, compute_dtype

        self.cell, self.conf, self.pool, self.device = cell, conf, pool, device
        self.n_seq = int(cell["n_seq"])
        cfg = unit_config(conf, cell)
        with torch.device("meta"):
            template = DispResNetIndoor(num_layers=int(cfg.MODEL.num_layers),
                                        dtype=compute_dtype(cfg))
        # The seeded tensors themselves become the template's: each unit
        # trains a copy (materialising the module on the card and copying
        # into it took 3-5 s of set-up).
        template.load_state_dict(weights, assign=True)
        self.template = template
        thr = float(cfg.DEMO.frame_threshold)
        self.counts = [[len(keyframe_schedule(p.cpu().numpy(), thr)) for p in unit["poses"]]
                       for unit in pool]
        if self.n_seq == 1:
            self.data = [SequenceData(unit["colors255"][0], *(x[0].cpu().numpy() for x in (
                unit["depths"], unit["K"], unit["poses"]))) for unit in pool]

    def unit(self, u: int, ranges: bool = False, keep: bool = False):
        """Pool unit ``u`` from the seeded weights. Returns its summary:
        per sequence the keyframes, every event's metrics, the first
        event's and every keyframe's abs_rel; refine steps, events and
        capture time; with ``keep``, the program's state before and after
        each sequence's last event (``record.py``) and the run's final
        state, held on the device for the check (``kept``)."""
        rf = torch.profiler.record_function if ranges else (lambda _: contextlib.nullcontext())
        cfg = unit_config(self.conf, self.cell)
        p = self.pool[u]
        with rf("slambench.build"):
            model = copy.deepcopy(self.template)
            if self.n_seq == 1:
                from e2eslam_tpu_torch.engine.adaptation import OnlineAdaptation

                runner = OnlineAdaptation(cfg, dataset=self.data[u], model=model,
                                          device=self.device)
            else:
                from e2eslam_tpu_torch.parallel.adaptation import ParallelAdaptation

                L, H, W = p["colors"].shape[1:4]
                runner = ParallelAdaptation(cfg, model, map_capacity=L * H * W,
                                            n_seq=self.n_seq, device=self.device)
                state = runner.init_state()
        rec = record.Recorder(record.snapshot_events(self.counts[u]) if keep else ())
        with rf("slambench.run"), (record.recording(rec) if keep else contextlib.nullcontext()):
            if self.n_seq == 1:
                res = runner.run(verbose=False)
            else:
                res = runner.run(state, (p["colors"], p["depths"], p["K"], p["poses"]),
                                 threshold=float(cfg.DEMO.frame_threshold),
                                 dispatch=self.cell["dispatch"])
        with rf("slambench.read"):
            out = summarize(res, self.n_seq)
            out["pool_unit"] = u
            if keep:
                out["kept"] = {"counts": self.counts[u], "snaps": rec.snaps,
                               "final": final_state(res, model, self.n_seq)}
        del res, runner, model
        return out


def summarize(res, n_seq: int):
    """What the benchmark keeps of a run's result."""
    if n_seq == 1:
        if not res["sequence_program"]:
            raise RuntimeError("the run did not take the whole-sequence program")
        seqs, events = [res], res["num_keyframes"]
    else:
        if res["dispatch"] != "whole":
            raise RuntimeError(f"the run took dispatch {res['dispatch']!r}, not the program")
        seqs, events = res["per_sequence"], res["num_events"]
    return {
        "steps": int(res["refine_steps"]),
        "events": int(events),
        "capture_s": float(res["capture_s"]),
        "sequences": [{
            "keyframes": [int(k) for k in s["keyframes"]],
            "first": {k: float(s["metrics"][0][k]) for k in ("total_loss", "abs_rel")},
            "metrics": [{k: float(v) for k, v in m.items() if isinstance(v, (int, float))}
                        for m in s["metrics"]],
            "abs_rel": [float(m["abs_rel"]) for m in s["metrics"] if m is not None],
        } for s in seqs],
    }


def final_state(res, model, n_seq: int):
    """The run's final weights (stacked on a sequence axis) and maps, as
    ``record.py`` lays out a state, read when called: references to the
    run's own tensors, which nothing writes once it has returned."""
    if n_seq == 1:
        maps = [res["map"]]
        weights = lambda: {k: v[None] for k, v in model.state_dict().items()}  # noqa: E731
    else:
        st, maps = res["state"], res["maps"]
        weights = lambda: {**st.params, **st.buffers}  # noqa: E731
    return lambda: {"weights": weights(),
                    "maps": [{f: getattr(m, f) for f in record.MAP_FIELDS
                              if getattr(m, f) is not None} for m in maps]}


def traced(runner, units, flops_per_step: float, peak_flops):
    """The pool units ``units`` under the profiler and the sync-debug
    warnings: the per-layer summary and the breakdown."""
    from slambench import trace

    cuda = runner.device.type == "cuda"
    acts = [torch.profiler.ProfilerActivity.CPU]
    if cuda:
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    summaries = []
    sync(runner.device)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        if cuda:
            torch.cuda.set_sync_debug_mode("warn")
        try:
            with torch.profiler.profile(activities=acts) as prof:
                for u in units:
                    with torch.profiler.record_function("slambench.unit"):
                        summaries.append(runner.unit(u, ranges=True))
                sync(runner.device)
        finally:
            if cuda:
                torch.cuda.set_sync_debug_mode("default")
    syncs = sum("synchroniz" in str(w.message) for w in caught)
    profile = trace.read_profile(prof.events())
    units_r = [r for r in profile["ranges"] if r[2] == "slambench.unit"]
    span = (min(r[0] for r in units_r), max(r[1] for r in units_r))
    bd = trace.breakdown(profile, span)
    steps = sum(s["steps"] for s in summaries)
    return {
        "units": len(units),
        "events": sum(s["events"] for s in summaries),
        "steps": steps,
        "host_syncs": syncs,
        "flops": flops_per_step * steps,
        "peak_flops": peak_flops,
        **bd,
    }


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    bench, cell, conf = load_cell(args.workload)
    entry = next(w for w in bench["workloads"] if w["name"] == args.workload)
    chips = int(entry["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:  # initialises CUDA
        print(f"slambench: needs {chips} CUDA card(s); torch.cuda.is_available()="
              f"{torch.cuda.is_available()}, device_count={torch.cuda.device_count()}",
              file=sys.stderr)
        return 3
    device = torch.device("cuda", 0)
    torch.zeros(1, device=device)  # the CUDA context, counted with the imports
    import e2eslam_tpu_torch.engine.adaptation  # noqa: F401
    import e2eslam_tpu_torch.parallel.adaptation  # noqa: F401
    result = run_cell(args, bench, cell, conf, device)
    found = sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))
    if found:
        print(f"slambench: the process holds {found}", file=sys.stderr)
        return 4
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


def run_cell(args, bench, cell, conf, device):
    """Set-up, window, traced units and check of one run; the result."""
    from e2eslam_tpu_torch.ops import cuda_build
    from slambench.peaks import peak
    from slambench.reference.online_pft import flops_per_event

    parts = {"imports_and_cuda_init": time.perf_counter() - T_START}

    def part(name, t):
        sync(device)
        parts[name] = time.perf_counter() - t
        return time.perf_counter()

    t = time.perf_counter()
    cfg = unit_config(conf, cell)
    if str(cfg.LOSS.get("knn_impl", "brute")) == "brute" and device.type == "cuda":
        cuda_build.build()
    t = part("knn_library", t)
    pool = traffic.render_pool(cell, conf["config"], device)
    order = traffic.order(cell, args.seed)
    t = part("render_pool", t)
    weights = seeded_weights(int(cell["weights_seed"]), device)
    t = part("weights", t)
    runner = Runner(cell, conf, pool, weights, device)
    t = part("runner", t)
    runner.unit(order[0])  # warm-up: the cell's own shapes
    part("warm_up_unit", t)
    t0 = time.perf_counter()
    setup_s = t0 - T_START
    keep = check.kept_positions(args.seed, len(pool), int(cell["check_units"]))
    units, u = [], 0
    while True:  # whole passes over the pool, until one ends past the time
        units.append(runner.unit(order[u % len(pool)], keep=u in keep))
        u += 1
        if u % len(pool) == 0 and time.perf_counter() - t0 >= args.seconds:
            break
    sync(device)
    window_s = time.perf_counter() - t0
    steps = sum(x["steps"] for x in units)
    abs_rels = [a for x in units for s in x["sequences"] for a in s["abs_rel"]]

    name = device_name(device)
    metrics, breakdown, dev_extra = {}, None, {}
    if args.trace:
        H, W = int(cfg.DATA.height), int(cfg.DATA.width)
        R = int(cfg.OPTIMIZATION.refinement_steps)
        flops_step = flops_per_event(H, W, 2, R) / R
        traced_units = [order[(u + i) % len(pool)] for i in range(int(cell["trace_units"]))]
        summary = traced(runner, traced_units, flops_step,
                         peak(name, str(cfg.SETTINGS.compute_dtype)))
        summary["window_capture_s"] = [x["capture_s"] for x in units]
        for mname, mod in per_layer_metrics(bench, cell["name"]).items():
            value = mod.read(summary)
            if value is not None:
                metrics[mname] = {"value": value, "unit": mod.UNIT}
        breakdown = {"device_ops": summary["top_ops"], "idle_gaps": summary["idle_gaps"]}
        dev_extra = {"busy_s": summary["busy_s"], "window_s": summary["window_s"]}
    else:
        metrics = {"steps_per_s": {"value": steps / window_s, "unit": "steps/s"},
                   "abs_rel": {"value": float(np.mean(abs_rels)), "unit": "ratio"},
                   "setup_s": {"value": setup_s, "unit": "s"}}
    peak_bytes = (torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0)
    attempted = sum(len(x["sequences"]) for x in units)
    failed = sum(1 for x in units for s in x["sequences"]
                 if not s["abs_rel"] or not np.all(np.isfinite(s["abs_rel"])))

    # The check: the program's state is freed, then the reference runs.
    del runner
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    checks = check.compare(cell, conf, pool, weights, units)
    correct = failed == 0 and all(c["value"] <= c["limit"] for c in checks.values())
    result = {"correct": bool(correct), "attempted": attempted, "failed": failed,
              "metrics": metrics,
              "device": {"platform": "gpu" if device.type == "cuda" else device.type,
                         "kind": name, "count": 1, "memory_peak_bytes": int(peak_bytes),
                         **dev_extra},
              "units": len(units), "window_s": window_s}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["setup_parts_s"] = parts
    result["checks"] = checks
    return result


def sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def device_name(device) -> str:
    return torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"


if __name__ == "__main__":
    sys.exit(main())
