"""Multi-process runs of the port's distributed paths on the CPU (gloo).

``run_world(job, world, inputs, tmp)`` starts ``world`` processes of this
file, one per rank. They import torch and the port only (never JAX), pin
one OpenMP thread, meet through a ``FileStore`` under ``tmp`` (no TCP
port, so parallel test workers never collide), run ``job`` on ``inputs``
and each write their result; every wait has its own timeout, so a hang
fails its test instead of stalling the suite. Returns the ranks' results.

Jobs:
  * ``knn``: a list of cases, each ``knn_map_sharded`` of a query set
    against a map row-sharded over the ranks (``layout`` ``map``), or over
    the ``map`` subgroups of a ``data x map`` layout (``data_map``: ranks
    ``d*M .. d*M+M-1`` form data slice ``d``'s map group);
  * ``points``: the sharded 3D losses of a frame against such a map: the
    frame->map loss and its indices, the aux (colour) lookup, and the
    bidirectional chamfer's value and frame gradient;
  * ``adapt``: ``ParallelAdaptation`` over a ``data`` axis of all ranks.
"""

import torch_omp  # noqa: F401  (first: OpenMP's wait policy, before torch loads)

import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def run_world(job, world, inputs, tmp, timeout=150):
    """Run ``job`` on ``world`` gloo ranks; returns the ranks' results."""
    import torch

    tmp = str(tmp)
    inp = os.path.join(tmp, f"{job}_in.pt")
    torch.save(inputs, inp)
    store = os.path.join(tmp, f"{job}_store")
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=ROOT)
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), job, store,
                               str(rank), str(world), inp,
                               os.path.join(tmp, f"{job}_out{rank}.pt")],
                              env=env, cwd=ROOT, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for rank in range(world)]
    logs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=timeout)
            logs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    bad = [(i, p.returncode) for i, p in enumerate(procs) if p.returncode != 0]
    if bad:
        raise RuntimeError(f"ranks failed {bad}:\n" + "\n".join(lg[-3000:] for lg in logs))
    return [torch.load(os.path.join(tmp, f"{job}_out{rank}.pt"), weights_only=False)
            for rank in range(world)]


def _knn(inputs, rank, world):
    import torch.distributed as dist

    from e2eslam_tpu_torch.ops.knn_sharded import knn_map_sharded, shard_map_rows

    out = []
    for case in inputs:
        group = None
        if case.get("layout") == "data_map":
            m = case["map"]
            groups = [dist.new_group(list(range(d * m, (d + 1) * m)))
                      for d in range(world // m)]
            group = groups[rank // m]
        aux = case.get("aux")
        res = knn_map_sharded(group, case["query"], shard_map_rows(case["ref"], group),
                              case.get("nr"), case.get("nq"),
                              with_points=case.get("with_points", False),
                              aux=None if aux is None else shard_map_rows(aux, group))
        out.append(res)
    return out


def _points(inputs, rank, world):
    from e2eslam_tpu_torch.losses.points_sharded import (
        chamfer_distance_map_sharded,
        knn_points_loss_map_sharded,
        nn_map_sharded,
    )
    from e2eslam_tpu_torch.ops.knn_sharded import shard_map_rows

    frame, n_map, n_q = inputs["frame"], inputs["n_map"], inputs["n_query"]
    map_local = shard_map_rows(inputs["map"])
    loss, idx = knn_points_loss_map_sharded(None, map_local, frame, n_map=n_map, n_query=n_q)
    _, _, win_cols = nn_map_sharded(None, frame, map_local, shard_map_rows(inputs["cols"]),
                                    n_map=n_map, n_query=n_q)
    f = frame.clone().requires_grad_(True)
    value = chamfer_distance_map_sharded(None, f, map_local, n_frame=n_q, n_map=n_map)
    value.backward()
    return {"loss": loss, "idx": idx, "win_cols": win_cols, "chamfer": value.detach(),
            "grad": f.grad}


def _adapt(inputs, rank, world):
    import torch

    from e2eslam_tpu_torch.models.depth_net import make_depth_model
    from e2eslam_tpu_torch.parallel.adaptation import ParallelAdaptation
    from e2eslam_tpu_torch.parallel.mesh import make_mesh

    torch.set_num_threads(1)
    cfg = inputs["config"]
    model = make_depth_model(cfg)
    par = ParallelAdaptation(cfg, model, map_capacity=inputs["capacity"],
                             mesh=make_mesh(device="cpu"), n_seq=inputs["n_seq"])
    out = par.run(par.init_state(), inputs["sequences"], threshold=inputs["threshold"])
    return {"per_sequence": out["per_sequence"], "num_events": out["num_events"],
            "map_points": [int(m.count) for m in out["maps"]], "mesh_size": par.mesh.size}


def main(argv):
    job, store, rank, world, inp, out = argv
    rank, world = int(rank), int(world)
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store, world), rank=rank,
                            world_size=world)
    try:
        inputs = torch.load(inp, weights_only=False)
        result = {"knn": _knn, "points": _points, "adapt": _adapt}[job](inputs, rank, world)
        torch.save(result, out)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    sys.path[:0] = [HERE, ROOT]
    main(sys.argv[1:])
