"""Core geometry: SE(3), intrinsics, projection, resampling, depth."""
