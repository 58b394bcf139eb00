"""Host-side datasets, augmentation and homography-pair synthesis (numpy, OpenCV, PIL)."""
