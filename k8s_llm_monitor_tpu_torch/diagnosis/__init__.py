"""Grammar-constrained verdicts (copy of the JAX package's jax-free
``diagnosis/grammar.py``)."""
