"""The receive chain in plain PyTorch."""
