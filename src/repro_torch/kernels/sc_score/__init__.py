"""Fused SC-score + Pareto prefilter + survivor compaction (one chunk)."""
