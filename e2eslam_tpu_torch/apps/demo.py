"""Demo: online adaptation with a map snapshot after every keyframe.

    python -m e2eslam_tpu_torch.apps.demo --config_path configs/config.yaml

The port of ``e2eslam_tpu/apps/demo.py`` (the reference's ``demo.py``, class
``Demo``): the online loop of ``engine/adaptation.py``, with the global map
copied to the host after each keyframe's fusion (its valid rows only), so
the map's growth can be exported: a PLY per keyframe and the animated
map-update HTML (``viz/animation.py``; the reference's
``plotly_map_update_visualization``, ``utils/advanced_vis.py:7-170``), plus
a plotly figure of the final map when plotly imports. Files go to
``{DEBUG.plot_path}/{SETTINGS.name}_demo``.
"""

from __future__ import annotations

import dataclasses
import os

from e2eslam_tpu_torch.config import load_config
from e2eslam_tpu_torch.engine.adaptation import OnlineAdaptation
from e2eslam_tpu_torch.slam.pointclouds import MapState
from e2eslam_tpu_torch.viz.pointcloud_export import export_ply, plotly_figure


class Demo(OnlineAdaptation):
    """Online adaptation that snapshots the map after every keyframe fusion
    (a host copy per keyframe: the per-keyframe loop, never the
    whole-sequence program)."""

    use_sequence_program = False

    def __init__(self, config, **kwargs):
        super().__init__(config, **kwargs)
        self.snapshots = []
        process = self.engine.process_pair

        def process_and_snapshot(*args, **kw):
            out = process(*args, **kw)
            self.snapshots.append(_host_snapshot(out[0]))
            return out

        self.engine.process_pair = process_and_snapshot

    def run(self, *, verbose=None):
        self.snapshots = []
        result = super().run(verbose=verbose)
        result["snapshots"] = self.snapshots
        return result

    def export_snapshots(self, out_dir: str, max_points: int = 50000):
        os.makedirs(out_dir, exist_ok=True)
        return [export_ply(snap, os.path.join(out_dir, f"map_{i:03d}.ply"),
                           max_points=max_points)
                for i, snap in enumerate(self.snapshots)]

    def export_animation(self, result, path: str, *, max_points: int = 50000,
                         ms_per_frame: int = 50) -> str:
        """Write the animated map-update HTML: one frame per keyframe with
        the camera frustum, its centre, the trajectory and the fused cloud,
        a slider and play/stop controls."""
        from e2eslam_tpu_torch.viz.animation import map_update_figure, write_animation_html

        fig = map_update_figure(result["snapshots"], result["est_poses"], result["intrinsics"],
                                max_points_per_frame=max_points, ms_per_frame=ms_per_frame)
        return write_animation_html(fig, path)


def _host_snapshot(m: MapState) -> MapState:
    """The map's valid rows on the host: a full-capacity copy on the card
    per keyframe would grow its memory by the buffer's size each time."""
    return dataclasses.replace(m, data=m.data[: m.count].detach().cpu(), index_image=None,
                               index_pose=None, index_image2=None, index_pose2=None)


def main(argv=None):
    config = load_config(argv)
    config.DEMO.sequence_length_refinement = config.DEMO.get("sequence_length_refinement", 2)
    demo = Demo(config)
    result = demo.run()
    out_dir = os.path.join(config.DEBUG.get("plot_path") or ".", f"{config.SETTINGS.name}_demo")
    paths = demo.export_snapshots(out_dir)
    print(f"exported {len(paths)} map snapshots to {out_dir}")
    anim = demo.export_animation(result, os.path.join(out_dir, "map_update.html"))
    print(f"wrote {anim}")
    fig = plotly_figure(result["map"])
    if fig is not None:
        fig.write_html(os.path.join(out_dir, "final_map.html"))
        print("wrote final_map.html")
    print(f"mean abs_rel: {result['mean_abs_rel']:.5f}")
    return result


if __name__ == "__main__":
    main()
