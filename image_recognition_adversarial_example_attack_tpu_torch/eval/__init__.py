"""Evaluation: the attack -> defend -> detect cell, the transfer cell, the
AutoAttack protocols and the black-box query curves, their streamed forms,
the perturbation metrics, the attack trajectories, Grad-CAM and the loss
landscape."""
