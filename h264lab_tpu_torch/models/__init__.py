"""Frame pipeline stages: wavefront plan, the macroblock engine and the
reference pictures."""
