"""Observability: point-cloud export, the map-update animation, scalar
logging, gradient histograms and debug images."""
