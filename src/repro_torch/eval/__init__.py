"""Sample-quality metrics and the per-transition ELBO table (port of
``repro.eval``)."""
from .elbo import TransitionTable, transition_elbo_table
from .metrics import (mmd_rbf, frechet_proxy, image_features, fid_proxy,
                      mode_coverage, high_level_similarity)

__all__ = ["TransitionTable", "transition_elbo_table",
           "mmd_rbf", "frechet_proxy", "image_features", "fid_proxy",
           "mode_coverage", "high_level_similarity"]
