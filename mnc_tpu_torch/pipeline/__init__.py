"""Post-processing and the canvas-space serving entry points."""
