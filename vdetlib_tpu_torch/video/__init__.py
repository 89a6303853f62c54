"""Video stages: detection step, MGP hop, tracking, rescoring, seq-NMS tubelets."""
