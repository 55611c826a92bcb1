"""Per-MB pixel and entropy-coding ops (PyTorch) and the bit-pack kernel."""
