"""The indoor depth network and the flax weight bridge."""
