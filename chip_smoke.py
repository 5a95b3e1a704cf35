#!/usr/bin/env python3
"""Drive e2eslam_tpu_torch's main path once on one CUDA card and check it.

    python3 chip_smoke.py

Phases (any failure ends the script with a non-zero exit):
  1. device   the card's name and power limit;
  2. build    nvcc builds every kernel from ops/csrc/ (one process per source);
  3. kernels  each of the three KNN kernels against its plain PyTorch version
              on the same inputs, at the on-chip check shapes (cold and warm),
              at main-path-like shapes and in a forced table overflow, and the
              dispatcher's distances against a float64 oracle;
  4. main     online adaptation from configs/config.yaml at full width
              (320x256, ResNet-18, 3 refine steps, brute three3d), only
              DEMO.sequence_length cut, with every kernel launch counted and
              the largest call of each kernel kept; those calls are then held
              against the plain versions and timed;
  5. small    the same path at 64x64 on the card and on the CPU (plain
              versions): the same keyframes, abs_rel and map size.
The second-to-last line is the kernels' JSON line, the last line the result.
Beside the timed fields, each kernel's entry there carries ``check_launches``
(its launches through the dispatcher in phase 3) and ``cdist_ms`` (a chunked
``torch.cdist(...).min(1)`` over the same valid rows: a yardstick the port
never calls, not a library version of the kernel).
The weights are random, drawn from a seed; the data is the synthetic scene.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))

# H100 SXM peaks (NVIDIA data sheet): fp32 on CUDA cores, HBM3 bandwidth.
PEAK_FP32 = 67e12
PEAK_BYTES = 3.35e12
OPS_PER_PAIR = 7  # 3 FMAs (6 flops) + 1 compare per (query, ref) pair

KERNEL_INFO = {
    "dense": ("knn_dense", "e2eslam_tpu/ops/knn.py:559"),
    "cand": ("knn_cand", "e2eslam_tpu/ops/knn.py:801"),
    "resident": ("knn_resident", "e2eslam_tpu/ops/knn.py:749"),
}
SOURCE = "e2eslam_tpu_torch/ops/csrc/knn.cu"


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def launch_counts(knn) -> dict:
    """Each kernel wrapper's launch count, read from ``knn.KERNELS`` (the
    wrappers themselves, whatever a Recorder has put in their place)."""
    return {k.__name__.split("_")[0]: k.launches for k in knn.KERNELS}


class Recorder:
    """Wraps the kernel wrappers of ``ops.knn``: every call goes through
    (and is counted by) the real wrapper; the largest call of each kernel
    (by visited-work proxy: query rows x ref rows) keeps its arguments."""

    def __init__(self, knn_mod):
        self.mod = knn_mod
        self.calls = {}
        self.orig = {}

    def __enter__(self):
        for key in KERNEL_INFO:
            name = f"{key}_kernel"
            orig = getattr(self.mod, name)
            self.orig[name] = orig

            def rec(*args, _key=key, _orig=orig, **kw):
                out = _orig(*args, **kw)
                size = args[0].shape[0] * args[1].shape[0]
                if _key not in self.calls or size >= self.calls[_key][0]:
                    self.calls[_key] = (size, args)
                return out

            setattr(self.mod, name, rec)
        return self

    def __exit__(self, *exc):
        for name, orig in self.orig.items():
            setattr(self.mod, name, orig)


def timed(fn, reps: int):
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    times.sort()
    return times[len(times) // 2]


def compare_call(knn, key, args, tag, stats, *, timing=False):
    """Kernel vs plain version on one call's arguments."""
    import torch

    plain, kern = getattr(knn, f"{key}_plain"), getattr(knn, f"{key}_kernel")
    q4, r4 = args[0], args[1]
    nq = args[-3]
    s_k, i_k = kern(*args)
    s_p, i_p = plain(*args)
    torch.cuda.synchronize()
    v = slice(0, nq)
    q = q4[v, :3].double()
    q2 = (q * q).sum(1)
    d_k = (q2 - 2 * s_k[v].double()).clamp(min=0)
    d_p = (q2 - 2 * s_p[v].double()).clamp(min=0)
    # fp32 rounding of the expanded score |q|^2 - 2 q.r + |r|^2: a few ulps
    # of the magnitudes that cancel in it.
    tol = 2e-5 * (1.0 + q2)
    err = (d_k - d_p).abs()
    if bool((err > tol).any()):
        bad = int((err > tol).sum())
        fail(f"{key} {tag}: {bad} distances differ from the plain version "
             f"(max {float(err.max()):.3g})")
    # Indices must agree wherever the nearest neighbour is unique: where they
    # differ, both picks must be equally near (in float64) within tolerance.
    diff = (i_k[v] != i_p[v]).nonzero()[:, 0]
    if diff.numel():
        r = r4[:, :3].double()
        dk = ((q[diff] - r[i_k[v][diff].long()]) ** 2).sum(1)
        dp = ((q[diff] - r[i_p[v][diff].long()]) ** 2).sum(1)
        if bool(((dk - dp).abs() > tol[diff]).any()):
            fail(f"{key} {tag}: indices differ where the nearest neighbour is unique")
    st = stats.setdefault(key, {"max_abs_err": 0.0, "checks": 0})
    st["max_abs_err"] = max(st["max_abs_err"], float(err.max()) if nq else 0.0)
    st["checks"] += 1
    line = {"phase": "kernels", "kernel": key, "case": tag, "nq": nq,
            "nr": int(args[-2]), "max_abs_err": float(err.max()) if nq else 0.0,
            "tol": "2e-5*(1+|q|^2)", "index_mismatches_at_ties": int(diff.numel())}
    if timing:
        line.update(measure(knn, key, args, kern, plain))
        st.update({k: line[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by", "case",
                                         "cdist_ms")})
    print(json.dumps(line), flush=True)


def measure(knn, key, args, kern, plain):
    """Kernel and plain times (CUDA events, median), and the bound."""
    import torch

    q4, r4 = args[0], args[1]
    n_qt = q4.shape[0] // knn.QT
    visits = torch.zeros(n_qt, dtype=torch.int32, device=q4.device)
    kern(*args, visits=visits)
    torch.cuda.synchronize()
    pairs = int(visits.long().sum()) * knn.QT
    ms = timed(lambda: kern(*args), 20)
    plain_ms = timed(lambda: plain(*args), 3)
    nbytes = sum(t.numel() * t.element_size() for t in args
                 if isinstance(t, torch.Tensor)) + q4.shape[0] * 8
    t_bytes = nbytes / PEAK_BYTES * 1e3
    t_ops = pairs * OPS_PER_PAIR / PEAK_FP32 * 1e3
    return {"ms": ms, "plain_ms": plain_ms, "bound_ms": max(t_bytes, t_ops),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "visited_pairs": pairs, "bytes": nbytes,
            "cdist_ms": timed(lambda: cdist_min(q4[:args[-3], :3], r4[:args[-2], :3]), 3)}


def cdist_min(q, r):
    """The yardstick the port never calls: ``torch.cdist(q, r).min(1)`` over
    the valid rows, chunked so one chunk's distance matrix stays under
    2 GiB. No single PyTorch call computes a seeded exact top-1, so this is
    reported beside the kernel, not as its library time."""
    import torch

    step = max(1, (1 << 29) // max(r.shape[0], 1))
    for s in range(0, q.shape[0], step):
        torch.cdist(q[s:s + step], r).min(dim=1)


def surface_points(n, gen, device, noise=0.0):
    """Points on the synthetic scene's box walls (4 x 3 x 5 m), optionally
    pushed off the surface by Gaussian noise."""
    import torch

    box = torch.tensor([4.0, 3.0, 5.0], device=device)
    p = torch.rand(n, 3, generator=gen, device=device) * box
    axis = torch.randint(0, 3, (n,), generator=gen, device=device)
    side = torch.randint(0, 2, (n,), generator=gen, device=device).float()
    rows = torch.arange(n, device=device)
    p[rows, axis] = side * box[axis]
    if noise:
        p = p + noise * torch.randn(n, 3, generator=gen, device=device)
    return p


def view_points(n, gen, device, noise=0.01):
    """``n`` points of the walls near one corner of the box (x < 1.5,
    y < 1.5, z < 2 m): the surface one camera view holds, like a frame's
    queries."""
    p = surface_points(16 * n, gen, device, noise)
    p = p[(p[:, 0] < 1.5) & (p[:, 1] < 1.5) & (p[:, 2] < 2.0)]
    if p.shape[0] < n:
        fail("too few view points drawn")
    return p[:n].contiguous()


def phase_kernels(knn, spatial_sort, stats):
    import torch

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)

    def oracle(q, r, nr):
        """float64 brute force (the tools/knn_tpu_check.py oracle)."""
        q, r = q.double(), r[:nr].double()
        best = torch.empty(q.shape[0], dtype=torch.float64, device=dev)
        r2 = (r * r).sum(1)
        for s in range(0, q.shape[0], 4096):
            blk = (q[s:s + 4096] ** 2).sum(1, keepdim=True) - 2 * q[s:s + 4096] @ r.T + r2
            best[s:s + 4096] = blk.min(1).values
        return best

    def dispatch(*args, **kw):
        """``knn.knn``, adding its launches to each kernel's phase-3 count."""
        before = launch_counts(knn)
        out = knn.knn(*args, **kw)
        for key, n in launch_counts(knn).items():
            st = stats.setdefault(key, {"max_abs_err": 0.0, "checks": 0})
            st["check_launches"] = st.get("check_launches", 0) + n - before[key]
        return out

    def check_dispatch(tag, q, r, nr=None, init=None, qperm=None, timing=False):
        with Recorder(knn) as rec:
            d, i = dispatch(q, r, nr, init_idx=init, q_perm=qperm)
        torch.cuda.synchronize()
        nr_ = r.shape[0] if nr is None else nr
        if nr_ * q.shape[0] <= 4e9:
            want = oracle(q, r, nr_)
            tol = 2e-5 * (1.0 + (q.double() ** 2).sum(1))
            if bool(((d.double() - want).abs() > tol).any()):
                fail(f"dispatcher {tag}: distances differ from the float64 oracle")
            via = ((q.double() - r[i.long()].double()) ** 2).sum(1)
            if bool(((via - want).abs() > tol).any()) or bool((i >= nr_).any()):
                fail(f"dispatcher {tag}: an index is not a nearest neighbour")
        for key, (_, args) in rec.calls.items():
            compare_call(knn, key, args, tag, stats, timing=timing)
        return d, i, set(rec.calls)

    # The on-chip check shapes of tools/knn_tpu_check.py, cold and warm.
    for nq, nr in [(1000, 5000), (256, 1024), (20480, 100000), (333, 777)]:
        q = torch.rand(nq, 3, generator=gen, device=dev) * 4 - 2
        r = torch.rand(nr, 3, generator=gen, device=dev) * 4 - 2
        _, i, _ = check_dispatch(f"{nq}x{nr} cold", q, r)
        mixed = torch.where(torch.rand(nq, generator=gen, device=dev) < 0.5, i,
                            torch.full_like(i, -1))
        check_dispatch(f"{nq}x{nr} warm", q, r, init=mixed)
        check_dispatch(f"{nq}x{nr} nr/2", q, r, nr=nr // 2)

    # Main-path-like shapes: 81,920 queries near the scene's surfaces.
    q = surface_points(81920, gen, dev, noise=0.01)
    r = surface_points(65536, gen, dev)
    _, _, used = check_dispatch("81920x65536 cold", q, r, timing=True)
    if "resident" not in used:
        fail("the 65,536-row cold search did not take the resident kernel")
    r = surface_points(196608, gen, dev)
    approx = torch.randint(0, r.shape[0], (q.shape[0],), generator=gen, device=dev)
    _, _, used = check_dispatch("81920x196608 warm", q, r, init=approx.int(),
                                timing=True)
    if "dense" not in used:
        fail("the 196,608-row warm search did not take the dense kernel")
    n_map = 1_500_000
    pts = surface_points(n_map, gen, dev)
    sm = spatial_sort.sort_map_points(pts, n_map)
    qv = view_points(81920, gen, dev)
    _, coarse = dispatch(qv, sm.points[::16].contiguous())  # a strided seed pass
    seed = (coarse.long() * 16).int()
    _, _, used = check_dispatch("81920x1.5M sorted warm", qv, sm.points, init=seed,
                                timing=True)
    if "cand" not in used:
        fail("the 1.5M-row seeded search did not take the candidate kernel")
    # Forced overflow: unseeded queries against > 2 * 131,072 rows make every
    # tile a candidate, so the dispatcher falls back to the dense kernel.
    none = torch.full((q.shape[0],), -1, dtype=torch.int32, device=dev)
    _, _, used = check_dispatch("81920x300000 overflow", q, sm.points[:300000], init=none)
    if used != {"dense"}:
        fail(f"the overflow call launched {sorted(used)}, not the dense kernel alone")


def phase_main(knn, stats):
    import torch

    from e2eslam_tpu_torch.config import default_config_path, load_yaml
    from e2eslam_tpu_torch.engine.adaptation import OnlineAdaptation

    cfg = load_yaml(default_config_path())
    cfg.DEMO.sequence_length = 12  # the only cut: ~10 keyframes
    runner = OnlineAdaptation(cfg)  # CUDA: the entry point's default
    for k in knn.KERNELS:
        k.launches = 0
    torch.cuda.reset_peak_memory_stats()
    with Recorder(knn) as rec:
        result = runner.run(verbose=False)
    launches = launch_counts(knn)
    for i, (frame, m) in enumerate(zip(result["keyframes"], result["metrics"])):
        print(json.dumps({"phase": "main", "keyframe": i, "frame": frame,
                          "loss": m["total_loss"], "photometric": m["photometric"],
                          "three3d": m["three3d"], "abs_rel": m["abs_rel"]}), flush=True)
    summary = {"phase": "main", "keyframes": result["num_keyframes"],
               "refine_steps": result["refine_steps"], "map_points": result["map_points"],
               "mean_abs_rel": result["mean_abs_rel"], "elapsed_s": result["elapsed_s"],
               "steps_per_sec": result["steps_per_sec"],
               "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
               "launches": launches, "capacity": runner.capacity}
    print(json.dumps(summary), flush=True)
    losses = [m["total_loss"] for m in result["metrics"]]
    if not result["metrics"] or not all(map(_finite, losses)):
        fail(f"non-finite or missing losses: {losses}")
    if not (0.0 < result["mean_abs_rel"] < 0.5):
        fail(f"mean abs_rel {result['mean_abs_rel']} outside (0, 0.5)")
    if not (0 < result["map_points"] <= runner.capacity):
        fail(f"map points {result['map_points']}")
    rows = result["map"].data[: result["map_points"]]
    if not bool(torch.isfinite(rows).all()):
        fail("non-finite map rows")
    for key in ("resident", "cand"):
        if launches[key] == 0:
            fail(f"the main path launched no {key} kernel")
    # The largest main-path call of each kernel: kernel vs plain, timed.
    for key, (_, args) in rec.calls.items():
        compare_call(knn, key, args, "main path", stats, timing=True)
    return launches, summary


def _finite(x) -> bool:
    return x == x and abs(x) != float("inf")


def phase_small():
    """The same path at 64x64: card (kernels, cuDNN) vs CPU (plain versions)."""
    from e2eslam_tpu_torch.config import default_config_path, load_yaml
    from e2eslam_tpu_torch.engine.adaptation import OnlineAdaptation

    def run(device):
        cfg = load_yaml(default_config_path())
        cfg.DATA.height, cfg.DATA.width = 64, 64
        cfg.DEMO.sequence_length = 5
        cfg.DEMO.frame_threshold = 0.01
        return OnlineAdaptation(cfg, device=device).run(verbose=False)

    a, b = run("cuda"), run("cpu")
    line = {"phase": "small", "keyframes": [a["num_keyframes"], b["num_keyframes"]],
            "mean_abs_rel": [a["mean_abs_rel"], b["mean_abs_rel"]],
            "map_points": [a["map_points"], b["map_points"]]}
    print(json.dumps(line), flush=True)
    if a["keyframes"] != b["keyframes"]:
        fail("card and CPU chose different keyframes")
    # The tolerances of tests/test_torch_engine.py's run against the JAX
    # package: the first keyframe (empty map) to 1e-3; later ones to 5%, as
    # nearest-neighbour near-ties flip a few neighbours and Adam's
    # normalised steps spread that; the map size to 1%.
    for k, (ma, mb) in enumerate(zip(a["metrics"], b["metrics"])):
        rtol = 1e-3 if k == 0 else 5e-2
        if abs(ma["abs_rel"] - mb["abs_rel"]) > rtol * abs(mb["abs_rel"]):
            fail(f"card and CPU abs_rel differ beyond {rtol} at keyframe {k}")
    if abs(a["map_points"] - b["map_points"]) > max(4, b["map_points"] // 100):
        fail("card and CPU map sizes differ beyond 1%")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script needs "
              "one CUDA card", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(ROOT, "e2eslam_tpu_torch")):
        print("chip_smoke: e2eslam_tpu_torch/ not found beside this script",
              file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    t0 = time.perf_counter()

    # 1. device
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60).stdout.strip().splitlines()[0]
    print(json.dumps({"phase": "device", "name": name, "count": torch.cuda.device_count(),
                      "torch": torch.__version__, "cuda": torch.version.cuda}), flush=True)

    # 2. build
    from e2eslam_tpu_torch.ops import cuda_build

    build_s = cuda_build.build()
    print(json.dumps({"phase": "build", "seconds": build_s}), flush=True)
    for src in cuda_build.SOURCES:
        with open(cuda_build.library_path(src) + ".log") as f:
            for ln in f:
                if "registers" in ln or "spill" in ln:
                    print(f"ptxas[{src}]: {ln.strip()}", flush=True)

    import e2eslam_tpu_torch.ops.knn as knn
    from e2eslam_tpu_torch.device import set_full_fp32
    from e2eslam_tpu_torch.ops import spatial_sort

    set_full_fp32()
    stats = {}
    # 3. kernels
    phase_kernels(knn, spatial_sort, stats)
    # 4. main path
    launches, _ = phase_main(knn, stats)
    # 5. small input, card vs CPU
    phase_small()

    kernels = []
    for key, (kname, replaces) in KERNEL_INFO.items():
        # Times come from the largest main-path call of the kernel; a kernel
        # the main path did not launch keeps its main-path-like phase-3 time.
        st = stats[key]
        kernels.append({"name": kname, "route": "cuda", "source": SOURCE,
                        "replaces": replaces, "launches": launches[key],
                        "max_abs_err": st.get("max_abs_err"), "ms": st.get("ms"),
                        "plain_ms": st.get("plain_ms"), "bound_ms": st.get("bound_ms"),
                        "bound_by": st.get("bound_by"), "library_ms": None,
                        "check_launches": st.get("check_launches", 0),
                        "cdist_ms": st.get("cdist_ms")})
    print(json.dumps({"phase": "done", "seconds": time.perf_counter() - t0}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
