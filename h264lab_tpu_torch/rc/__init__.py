"""Rate control."""
