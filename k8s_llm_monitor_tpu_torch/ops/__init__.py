"""Tensor ops: norms, rotary embeddings, attention oracles, kernel wrappers,
sampling."""
