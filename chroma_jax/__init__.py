"""chroma_jax: an optical photon Monte Carlo framework in JAX.

A ground-up re-engineering of the capabilities of Chroma
(github.com/pennneutrinos/chroma) as XLA programs: photons are SoA JAX
arrays propagated by wavefront programs through a BVH-accelerated
triangle-mesh geometry, with counter-based (threefry) RNG and
segment-reductions in place of CUDA atomics.

Public API mirrors the reference framework:
Geometry / Detector / Solid / Material / Surface build scenes,
Simulation drives event generation + propagation + DAQ, and
Likelihood/PDF machinery supports event reconstruction.
"""

__version__ = "0.1.0"

from chroma_jax import event
from chroma_jax.event import Photons, Vertex, Event, Channels
from chroma_jax.geometry import (Mesh, Solid, Material, Surface,
                                 DichroicProps, Geometry, vacuum,
                                 standard_wavelengths)
from chroma_jax.detector import Detector
from chroma_jax import make
from chroma_jax.stl import mesh_from_stl
from chroma_jax.loader import load_geometry_from_string, create_geometry_from_obj

__all__ = [
    'event', 'Photons', 'Vertex', 'Event', 'Channels',
    'Mesh', 'Solid', 'Material', 'Surface', 'DichroicProps', 'Geometry',
    'vacuum', 'standard_wavelengths', 'Detector', 'make', 'mesh_from_stl',
    'load_geometry_from_string', 'create_geometry_from_obj',
]
