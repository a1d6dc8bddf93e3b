"""Compute-path ops: CG solver and its fused update kernel, curvature
matvecs, step selection."""
