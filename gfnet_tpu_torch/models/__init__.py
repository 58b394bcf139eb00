"""Model modules: DINOv2 ViT, cross-view decoder, FPN, ConvRefiner, GFNet head."""
