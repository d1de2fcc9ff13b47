"""chroma_jax.ops: the JAX/XLA compute engine.

This package replaces the reference's CUDA device layer
(reference: chroma/cuda/*) with whole-array wavefront programs:
photons are structure-of-arrays jnp arrays, BVH traversal is a
vectorized stack machine over the whole batch, physics is a
branch-free jnp.where lattice, RNG is counter-based threefry, and
DAQ/PDF reductions are segment ops instead of atomics.
"""
