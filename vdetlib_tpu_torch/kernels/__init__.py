"""Flow, NMS and seq-NMS on tensors, with the wrappers of the hand-written CUDA kernels."""
