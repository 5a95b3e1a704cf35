"""The refinement engine and the online-adaptation runner."""
