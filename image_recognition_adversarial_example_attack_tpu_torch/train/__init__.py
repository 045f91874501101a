"""Adversarial and certified training (port of ``train/``)."""
