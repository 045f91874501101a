"""Figures of the port's CLIs (PIL only; imported where a CLI plots)."""
