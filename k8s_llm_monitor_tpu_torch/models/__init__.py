"""Model configurations and the Llama-family decoder in PyTorch."""
