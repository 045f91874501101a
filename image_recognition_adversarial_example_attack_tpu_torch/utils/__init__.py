"""Host-side utilities: phase timing, the streaming input pipeline and the
native image loader."""
