"""Online adaptation, the product workload, from the command line.

``python -m e2eslam_tpu_torch.apps.online_adaption --config_path
configs/config.yaml --name run1`` -- keyframe selection, per-pair depth
refinement (PFT), PointFusion into the global map, and the summary the JAX
app prints, with whether the run took the whole-sequence program, the CUDA
graphs it captured and their capture time (``DEBUG.print_metrics: false``
takes the program where the config allows it; the per-step prints of
``print_metrics: true`` take the per-keyframe loop). With
``VIZ.plot_final_step`` the final map is written as
``{DEBUG.plot_path or "."}/{SETTINGS.name}_map.ply`` (at most 200,000
points), as the JAX app writes it. Runs on CUDA unless ``SETTINGS.device``
is ``cpu``.
``--set SECTION.key=value`` overrides a setting, for example the ICL-NUIM
configuration on the repository's 10-frame sequence with a checkpoint
directory of one's own::

    python -m e2eslam_tpu_torch.apps.online_adaption \
        --config_path configs/config_icl_online.yaml --data_path tests/data \
        --set DEMO.sequence_length=10 --set DATA.dilation=0 \
        --set DEMO.frame_threshold=0.01 --set MODEL.load_depth_path=CKPT_DIR
"""

from __future__ import annotations

import os

from e2eslam_tpu_torch.config import load_config
from e2eslam_tpu_torch.engine.adaptation import OnlineAdaptation
from e2eslam_tpu_torch.viz.pointcloud_export import export_ply


def main(argv=None):
    config = load_config(argv)
    result = OnlineAdaptation(config).run()
    print(f"keyframes: {result['num_keyframes']}")
    print(f"map points: {result['map_points']}")
    if "map_points_compacted" in result:
        print(f"map points after compaction: {result['map_points_compacted']}")
    print(f"mean abs_rel: {result['mean_abs_rel']:.5f}")
    print(f"ate: {result['ate']:.5f}  rpe: {result['rpe']:.5f}")
    print(f"refinement steps/sec (adapt+fuse): {result['steps_per_sec']:.3f}")
    print(f"sequence_program: {result['sequence_program']}  graphs: {result['graphs']}  "
          f"capture_s: {result['capture_s']:.3f}")
    if config.VIZ.get("plot_final_step"):
        out = os.path.join(config.DEBUG.get("plot_path") or ".", f"{config.SETTINGS.name}_map.ply")
        print("map exported to", export_ply(result["map"], out, max_points=200000))
    return result


if __name__ == "__main__":
    main()
