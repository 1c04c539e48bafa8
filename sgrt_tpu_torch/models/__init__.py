"""Scene and camera dataclasses."""
