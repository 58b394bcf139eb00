"""Projective geometry and robust homography solving."""
