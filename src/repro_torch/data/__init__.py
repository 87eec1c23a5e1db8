"""Synthetic data pipelines of the port (``repro/data``)."""
from .synthetic import (GaussianMixture2D, SyntheticImages, SyntheticTokens,
                        make_image_pipeline, make_token_pipeline)

__all__ = ["SyntheticImages", "SyntheticTokens", "GaussianMixture2D",
           "make_image_pipeline", "make_token_pipeline"]
