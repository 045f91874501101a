"""Constants, normalization, image IO, labels, generators, the device rule."""
