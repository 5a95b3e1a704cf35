"""Readings behind the limits of the output check, in one process.

    python3 slambench/control.py --workload CELL --seeds 1 2 3 ... \\
        [--units N] [--control tf32|fp8] [--faults] [--planted-seeds K]

For each seed, as a run of the cell sets it up (pool, weights, the seed's
order): the first ``N`` units of the seed's order (every pool unit by
default) through the program, each keeping its state for the check, then
the plain reference (``check.py``); prints one JSON line a seed with the
program's numbers (the lower readings), the control's (the reference with
its convolutions in ``--control``'s lower precision put in the program's
place: the upper readings) and, with ``--faults``, those of the program
with each planted fault the cell can have (``faults.py``), the control and
the faults on the first ``K`` seeds only (all by default). The benchmark's
own runs never run this.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
if sys.path and os.path.abspath(sys.path[0]) == HERE:
    sys.path[0] = ROOT

import torch  # noqa: E402

from slambench import check, faults, traffic  # noqa: E402
from slambench.run import Runner, load_cell, network_weights  # noqa: E402


def prepare(cell, conf, device):
    """(pool, weights, runner) as a run of the cell sets them up."""
    pool = traffic.render_pool(cell, conf["config"], device)
    weights = network_weights(cell, conf, device)
    return pool, weights, Runner(cell, conf, pool, weights, device)


def readings(cell, conf, seed: int, device, control: str = None, fault_names=(),
             units: int = None, prepared=None):
    """{"program": numbers, "control": numbers, "<fault>": numbers} of one
    seed over the first ``units`` units of its order; ``prepared``:
    ``prepare``'s, made anew when None."""
    pool, weights, runner = prepared or prepare(cell, conf, device)
    order = traffic.order(cell, seed)[:units]
    runs = [runner.unit(u, keep=True) for u in order]
    faulty = {}
    for name in fault_names:
        with faults.planted(name):
            faulty[name] = [runner.unit(u, keep=True) for u in order]
    refs = check.first_events(conf, pool, weights, set(order))

    def numbers(us):
        out = check.gaps([(x["pool_unit"], x["sequences"]) for x in us], refs)
        out.update(check.event_check(conf, pool, us))
        out["unmoved_leaves"] = check.unmoved(weights, us, refs)
        return out

    out = {"seed": seed, "program": numbers(runs)}
    for name, us in faulty.items():
        out[name] = numbers(us)
    if control:
        out["control"] = check.control(conf, pool, weights, control, refs, runs)
    return out


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--control", choices=("tf32", "fp8"), default=None)
    p.add_argument("--faults", action="store_true")
    p.add_argument("--units", type=int, default=None)
    p.add_argument("--planted-seeds", type=int, default=None)
    args = p.parse_args(argv)
    _, cell, conf = load_cell(args.workload)
    if not torch.cuda.is_available():
        raise SystemExit("control.py reads the card: no CUDA device")
    device = torch.device("cuda", 0)
    names = faults.faults_for(cell) if args.faults else ()
    prepared = prepare(cell, conf, device)
    for i, seed in enumerate(args.seeds):
        planted = args.planted_seeds is None or i < args.planted_seeds
        r = readings(cell, conf, seed, device, args.control if planted else None,
                     names if planted else (), args.units, prepared)
        print(json.dumps(dict(r, workload=cell["name"],
                              device=torch.cuda.get_device_name(device))), flush=True)


if __name__ == "__main__":
    main()
