"""Color maps for rendering (parity: chroma/color)."""
from chroma_jax.color.chromaticity import map_wavelength
from chroma_jax.color.colormap import map_to_color

__all__ = ['map_wavelength', 'map_to_color']
