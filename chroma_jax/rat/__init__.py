"""GDML/RATDB geometry import (parity subset: chroma/rat)."""
from chroma_jax.rat.loader import RATGeoLoader, Volume
from chroma_jax.rat.ratdb_parser import RatDBParser

__all__ = ['RATGeoLoader', 'Volume', 'RatDBParser']
