"""Evaluation: the attack -> defend -> detect cell, the transfer cell, their
streamed forms, the perturbation metrics, the attack trajectories, Grad-CAM
and the loss landscape."""
