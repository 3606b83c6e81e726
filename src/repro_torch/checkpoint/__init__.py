"""Checkpoints of the port: atomic save and restore of nested state."""
