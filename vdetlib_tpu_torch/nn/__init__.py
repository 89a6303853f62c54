"""Networks: detector (backbone + ROI head) and correlation tracker."""
