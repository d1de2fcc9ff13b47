"""Photon/vertex generation (parity: chroma/generator/)."""
from chroma_jax.generator import vertex
from chroma_jax.generator import photon
from chroma_jax.generator.photon import (G4ParallelGenerator,
                                         ParametricGenerator, photon_bomb)

__all__ = ['vertex', 'photon', 'G4ParallelGenerator',
           'ParametricGenerator', 'photon_bomb']
