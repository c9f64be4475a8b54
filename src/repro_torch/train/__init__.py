"""The training step and loop."""
