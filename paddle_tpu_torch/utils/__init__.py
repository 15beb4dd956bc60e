"""Host-side utilities of the port (pure Python)."""
