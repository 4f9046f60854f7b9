"""Competitor baselines, one per family the paper compares against (§5),
the counterpart of ``repro.baselines``:

  E2LSH      — LSH / collision counting (guarantees family)
  IVFFlat    — vector quantisation, coarse inverted file
  IMIPQ      — IMI + Multi-sequence (OPQ-lite, M=2)
  HNSWLite   — proximity graph (its walk stays on the host)
  RPForest   — random-projection trees (Annoy-style)

Each draws the reference's random numbers in the reference's order, builds
and queries on the device its ``device`` names (the card by default;
``HNSWLite`` on the host), and ``from_state`` serves the reference's own
built state.
"""

from repro_torch.baselines.ivf import IVFFlat
from repro_torch.baselines.lsh import E2LSH
from repro_torch.baselines.imi_pq import IMIPQ
from repro_torch.baselines.hnsw import HNSWLite
from repro_torch.baselines.rpforest import RPForest

__all__ = ["IVFFlat", "E2LSH", "IMIPQ", "HNSWLite", "RPForest"]
