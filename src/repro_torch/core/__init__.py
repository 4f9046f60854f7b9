"""SuCo on torch: subspaces, distances, pools, tiling, K-means and the
index and query of :mod:`repro_torch.core.suco`."""
