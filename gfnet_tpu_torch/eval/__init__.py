"""Evaluation: the homography benchmark (`benchmark`), the single-pair demo
(`demo`, `visualize`), the synthetic pairs and training stream
(`synthetic`), and the synthetic flows the local-correlation kernels are
checked and timed on (`flows`)."""
