"""Host-side utilities: phase timing."""
