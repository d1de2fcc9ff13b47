"""Histogram utilities (parity: chroma/histogram)."""
from chroma_jax.histogram.histogram import Histogram
from chroma_jax.histogram.histogramdd import HistogramDD
from chroma_jax.histogram.graph import Graph

__all__ = ['Histogram', 'HistogramDD', 'Graph']
