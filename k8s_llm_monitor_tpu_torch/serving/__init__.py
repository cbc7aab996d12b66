"""Continuous-batching engine and paged-KV block management."""
