"""RGB-D frame geometry, the packed map, PointFusion."""
