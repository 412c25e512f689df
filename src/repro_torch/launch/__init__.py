"""Step builders of the serving path (prefill, one-token decode)."""
