"""Online adaptation, the product workload, from the command line.

``python -m e2eslam_tpu_torch.apps.online_adaption --config_path
configs/config.yaml --name run1`` -- keyframe selection, per-pair depth
refinement (PFT), PointFusion into the global map, and the summary the JAX
app prints. Runs on CUDA unless ``SETTINGS.device`` is ``cpu``.
``--set SECTION.key=value`` overrides a setting, for example the ICL-NUIM
configuration on the repository's 10-frame sequence with a checkpoint
directory of one's own::

    python -m e2eslam_tpu_torch.apps.online_adaption \
        --config_path configs/config_icl_online.yaml --data_path tests/data \
        --set DEMO.sequence_length=10 --set DATA.dilation=0 \
        --set DEMO.frame_threshold=0.01 --set MODEL.load_depth_path=CKPT_DIR
"""

from __future__ import annotations

from e2eslam_tpu_torch.config import load_config
from e2eslam_tpu_torch.engine.adaptation import OnlineAdaptation


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
    return result


if __name__ == "__main__":
    main()
