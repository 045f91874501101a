"""Evaluation: the attack -> defend -> detect cell, the transfer cell, their
streamed forms, the perturbation metrics and the attack trajectories."""
