"""Candidate gather + exact squared L2 (the in-pass rerank)."""
