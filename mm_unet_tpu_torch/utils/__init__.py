"""Utilities: JAX -> torch weight conversion."""
