"""The attack -> defend -> detect evaluation cell."""
