"""The fused single-program pipeline."""
