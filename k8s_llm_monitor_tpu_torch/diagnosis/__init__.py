"""Grammar-constrained verdicts, follow-up sessions and the standing
diagnosis pipeline (copies of the JAX package's jax-free ``diagnosis/``
modules)."""
