"""Host-side utilities: phase timing and the streaming input pipeline."""
