"""Pairwise squared L2 distances, summed in a fixed order."""
