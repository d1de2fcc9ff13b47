"""chroma_jax.bvh: BVH generation and manipulation (CPU-vectorized)."""
from chroma_jax.bvh.bvh import (BVH, BVHLayerSlice, WorldCoords,
                                OutOfRangeError, CHILD_BITS, NCHILD_MASK,
                                uint4, to_uint4, from_uint4, unpack_nodes,
                                node_areas)
from chroma_jax.bvh.build import (make_recursive_grid_bvh, make_simple_bvh,
                                  create_leaf_nodes, merge_nodes,
                                  merge_nodes_detailed, concatenate_layers,
                                  collapse_chains, MAX_CHILD)

__all__ = ['BVH', 'BVHLayerSlice', 'WorldCoords', 'OutOfRangeError',
           'CHILD_BITS', 'NCHILD_MASK', 'uint4', 'to_uint4', 'from_uint4',
           'unpack_nodes', 'node_areas', 'make_recursive_grid_bvh',
           'make_simple_bvh', 'create_leaf_nodes', 'merge_nodes',
           'merge_nodes_detailed', 'concatenate_layers', 'collapse_chains',
           'MAX_CHILD']
