"""Detection evaluation (numpy, host side)."""
