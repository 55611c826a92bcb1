"""GOP-lane x slice-band encoder."""
