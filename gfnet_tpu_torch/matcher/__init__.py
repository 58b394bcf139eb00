"""Two-pass match / sample / estimate_homography API."""

from gfnet_tpu_torch.matcher.api import GFNetMatcher

__all__ = ["GFNetMatcher"]
