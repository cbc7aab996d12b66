"""Host-side utilities."""
