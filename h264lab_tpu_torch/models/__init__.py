"""Frame pipeline stages: wavefront plan and the macroblock engine."""
