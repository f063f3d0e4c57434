"""PyTorch modules of the 2.1 text2img path."""
