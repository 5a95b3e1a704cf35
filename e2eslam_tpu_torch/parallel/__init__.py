"""Several sequences at once: the mesh, the lockstep refinement step and the
multi-sequence runner."""
