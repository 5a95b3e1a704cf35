"""Losses: SSIM+L1 photometric, 3D point loss, depth metrics, trajectory errors."""
