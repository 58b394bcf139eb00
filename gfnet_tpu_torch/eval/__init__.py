"""Evaluation helpers: the synthetic homography stream (`synthetic`) and the
synthetic flows the local-correlation kernels are checked and timed on
(`flows`)."""
