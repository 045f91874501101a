"""Evaluation: the attack -> defend -> detect cell, its streamed form, the
perturbation metrics and the attack trajectories."""
