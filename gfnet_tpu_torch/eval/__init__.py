"""Evaluation helpers; today the synthetic homography stream."""
