"""PyTorch modules of the port (UNets, prior, text towers, codecs, LoRA)."""
