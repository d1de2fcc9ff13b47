"""Pack a flattened Geometry/Detector into device-resident jnp tables.

Replaces the reference's by-hand CUDA struct packing (reference:
chroma/gpu/geometry.py GPUGeometry, chroma/gpu/detector.py GPUDetector)
with flat, padded jnp arrays in a pytree dataclass:

  * per-material wavelength tables stacked as (M, W) arrays sampled on
    a uniform grid, so property lookup is a gather + lerp
    (reference: chroma/cuda/geometry.h interp_property);
  * multi-component reemission tables padded to (M, C, W) / (M, C, T);
  * per-surface tables stacked as (S, W) plus model/thickness vectors;
  * dichroic angle x wavelength tables padded to (S, A, W);
  * triangle material codes packed (inner<<24 | outer<<16 | surface<<8)
    exactly like the reference ABI (chroma/gpu/geometry.py:203);
  * the BVH node array as (N, 4) uint32 with 16-bit quantized AABBs.

Everything lives in device memory, replicated across devices when
sharding photons.
"""
import dataclasses

import numpy as np
import jax
import jax.numpy as jnp

from chroma_jax.geometry import standard_wavelengths
from chroma_jax.bvh.bvh import from_uint4

def _static(default):
    """A field carried as static pytree metadata: hashable, part of the
    jit cache key, never traced."""
    return dataclasses.field(default=default,
                             metadata={'pytree_node': False})


def _pytree_dataclass(cls):
    """Frozen dataclass registered as a JAX pytree: fields made with
    ``_static`` are metadata, every other field is a leaf."""
    cls = dataclasses.dataclass(frozen=True)(cls)
    fields = dataclasses.fields(cls)
    jax.tree_util.register_dataclass(
        cls,
        data_fields=[f.name for f in fields
                     if f.metadata.get('pytree_node', True)],
        meta_fields=[f.name for f in fields
                     if not f.metadata.get('pytree_node', True)])
    cls.replace = dataclasses.replace
    return cls


DEFAULT_TIME_GRID = np.arange(0.0, 1000.0, 0.05, dtype=np.float32)


def interp_material_property(wavelengths, prop):
    """Linearly resample a (n,2) (wavelength,value) table onto a grid.

    Linear interpolation is essential: it guarantees that surface
    probabilities that sum to 1 still sum to 1 after resampling
    (reference: chroma/gpu/geometry.py:41)."""
    prop = np.asarray(prop)
    return np.interp(wavelengths, prop[:, 0], prop[:, 1]).astype(np.float32)


@_pytree_dataclass
class GeometryTables:
    """Device-side geometry (pytree of jnp arrays + static grid params)."""
    # mesh
    vertices: jnp.ndarray          # (V,3) f32
    triangles: jnp.ndarray         # (T,3) i32
    tri_vertices: jnp.ndarray      # (T,3,3) f32 pre-assembled triangles
    material_codes: jnp.ndarray    # (T,)  u32
    colors: jnp.ndarray            # (T,)  u32
    solid_id_map: jnp.ndarray      # (T,)  i32
    # BVH (stackless: escape pointers precomputed from the layered tree)
    nodes: jnp.ndarray             # (N,4) u32
    escape: jnp.ndarray            # (N,)  u32 next-node-if-skip ("ropes")
    world_origin: jnp.ndarray      # (3,)  f32 (MBVH world box)
    world_scale: jnp.ndarray       # ()    f32
    # the legacy escape-rope walker decodes `nodes` with the legacy
    # BVH's own grid (an instanced MBVH's world box is slightly wider)
    legacy_world_origin: jnp.ndarray  # (3,) f32
    legacy_world_scale: jnp.ndarray   # ()   f32
    # MBVH: wide fat-row tree, the production traversal structure
    mbvh_rows: jnp.ndarray         # (R, ROW_WIDTH) u32
    # materials (M = #materials, C = max components, W/Tn = grid sizes)
    refractive_index: jnp.ndarray     # (M,W)
    absorption_length: jnp.ndarray    # (M,W)
    scattering_length: jnp.ndarray    # (M,W)
    num_comp: jnp.ndarray             # (M,)  i32
    comp_reemission_prob: jnp.ndarray      # (M,C,W)
    comp_reemission_wvl_cdf: jnp.ndarray   # (M,C,W)
    comp_reemission_time_cdf: jnp.ndarray  # (M,C,Tn)
    comp_absorption_length: jnp.ndarray    # (M,C,W)
    # surfaces (S = #surfaces)
    surf_detect: jnp.ndarray           # (S,W)
    surf_absorb: jnp.ndarray           # (S,W)
    surf_reemit: jnp.ndarray           # (S,W)
    surf_reflect_diffuse: jnp.ndarray  # (S,W)
    surf_reflect_specular: jnp.ndarray # (S,W)
    surf_eta: jnp.ndarray              # (S,W)
    surf_k: jnp.ndarray                # (S,W)
    surf_reemission_cdf: jnp.ndarray   # (S,W)
    surf_model: jnp.ndarray            # (S,) i32
    surf_transmissive: jnp.ndarray     # (S,) i32
    surf_thickness: jnp.ndarray        # (S,) f32
    # dichroic (A = max angle samples)
    dichroic_angles: jnp.ndarray       # (S,A) f32
    dichroic_nangles: jnp.ndarray      # (S,)  i32
    dichroic_reflect: jnp.ndarray      # (S,A,W)
    dichroic_transmit: jnp.ndarray     # (S,A,W)
    # inverse CDFs on a uniform u-grid (one gather + lerp per sample,
    # replacing the reference's per-sample binary search
    # chroma/cuda/random.h sample_cdf)
    comp_reemission_wvl_icdf: jnp.ndarray   # (M,C,NU)
    comp_reemission_time_icdf: jnp.ndarray  # (M,C,NU)
    surf_reemission_icdf: jnp.ndarray       # (S,NU)
    # static uniform-grid parameters
    wavelength0: float = _static(60.0)
    wavelength_step: float = _static(5.0)
    nwavelengths: int = _static(188)
    time0: float = _static(0.0)
    time_step: float = _static(0.05)
    ntimes: int = _static(20000)
    mbvh_depth: int = _static(8)
    # True when mbvh_rows is a TLAS/BLAS instanced tree (the walker
    # compiles the instance-entry handling only when set)
    mbvh_instanced: bool = _static(False)
    nu: int = _static(2048)
    # static capability flags: jit specializes away unused physics
    has_reemission: bool = _static(False)
    has_surfaces: bool = _static(False)
    has_complex: bool = _static(False)
    has_wls: bool = _static(False)
    has_dichroic: bool = _static(False)
    max_comp: int = _static(1)


@_pytree_dataclass
class DetectorTables:
    """Channel maps + shared readout CDFs (reference:
    chroma/cuda/detector.h)."""
    solid_id_to_channel_index: jnp.ndarray  # (n_solids,) i32
    time_cdf_x: jnp.ndarray                 # (Lt,) f32
    time_cdf_y: jnp.ndarray                 # (Lt,) f32
    charge_cdf_x: jnp.ndarray               # (Lq,) f32
    charge_cdf_y: jnp.ndarray               # (Lq,) f32
    time_icdf: jnp.ndarray                  # (NU,) f32
    charge_icdf: jnp.ndarray                # (NU,) f32
    charge_unit: jnp.ndarray                # ()    f32
    nchannels: int = _static(0)


N_ICDF = 2048
_UGRID = np.linspace(0.0, 1.0, N_ICDF).astype(np.float32)


def inverse_cdf(cdf_x, cdf_y, ugrid=_UGRID):
    """Tabulate the inverse of a CDF (cdf_y monotonic on cdf_x) on a
    uniform u-grid, so sampling is one gather + lerp."""
    cdf_x = np.asarray(cdf_x, dtype=np.float64)
    cdf_y = np.asarray(cdf_y, dtype=np.float64)
    # guard degenerate/flat CDFs
    if cdf_y[-1] <= 0:
        return np.full(len(ugrid), cdf_x[0], dtype=np.float32)
    y = cdf_y / cdf_y[-1]
    return np.interp(ugrid, y, cdf_x).astype(np.float32)


def sample_icdf(icdf, u):
    """Draw from a tabulated inverse CDF: icdf (..., NU), u in [0,1)."""
    nu = icdf.shape[-1]
    x = u * (nu - 1)
    j = jnp.clip(x.astype(jnp.int32), 0, nu - 2)
    f = x - j
    lo = jnp.take_along_axis(icdf, j[..., None], axis=-1)[..., 0] \
        if icdf.ndim > 1 else icdf[j]
    hi = jnp.take_along_axis(icdf, (j + 1)[..., None], axis=-1)[..., 0] \
        if icdf.ndim > 1 else icdf[j + 1]
    return lo + (hi - lo) * f


INSTANCING_MIN_GAIN = 100_000       # duplicated triangles worth a TLAS


def _want_instancing(geometry, instancing):
    """Resolve the instancing policy: explicit argument, then the
    CHROMA_JAX_INSTANCING env var, then auto (instanced when repeated
    placements duplicate >= INSTANCING_MIN_GAIN triangles)."""
    import os
    from chroma_jax.bvh.mbvh import instancing_gain
    if instancing is None:
        env = os.environ.get('CHROMA_JAX_INSTANCING')
        if env is not None:
            instancing = env.lower() not in ('0', 'false', 'no')
    if instancing is None:
        return instancing_gain(geometry) >= INSTANCING_MIN_GAIN
    return bool(instancing)


def _load_or_build_mbvh(geometry, material_codes, instancing=None):
    """Build (or load from the BVH cache) the wide fat-row MBVH.

    With instancing (auto for heavily repeated placements, e.g. PMT
    arrays) a TLAS over placements + one shared BLAS per unique solid
    replaces the flat tree: the 42M-triangle demo stores ~50k unique
    triangles and the traversal working set drops ~1000x."""
    from hashlib import md5 as _md5
    from chroma_jax.bvh.mbvh import build_mbvh, build_mbvh_instanced
    from chroma_jax.cache import Cache

    from chroma_jax.bvh.mbvh import (BRANCH, ROW_WIDTH, LAYOUT_VERSION,
                                     TARGET_DEGREE, builder_tag)
    use_inst = _want_instancing(geometry, instancing)
    # cluster rows bake in material codes, so they join the cache key;
    # the layout parameters AND the grouping degree AND the builder
    # algorithm version the format (each alters the tree, not just
    # the encoding)
    name = 'mbvh%d_%d_d%d_v%d_%s_%s' % (BRANCH, ROW_WIDTH, TARGET_DEGREE,
                                        LAYOUT_VERSION, builder_tag(),
                                        'i' if use_inst else 'f') \
        + _md5(np.ascontiguousarray(material_codes)).hexdigest()[:10]
    try:
        cache = Cache()
        mesh_hash = geometry.mesh.md5()
        if cache.exist_bvh(mesh_hash, name):
            return cache.load_bvh(mesh_hash, name)
    except Exception:
        cache = None
    mbvh = None
    if use_inst:
        mbvh = build_mbvh_instanced(geometry, material_codes)
    if mbvh is None:
        mbvh = build_mbvh(geometry.mesh, material_codes=material_codes)
    if cache is not None:
        try:
            cache.save_bvh(mbvh, mesh_hash, name)
        except Exception:
            pass
    return mbvh


ESCAPE_SENTINEL = np.uint32(0xFFFFFFFF)


def compute_escape_pointers(nodes_arr):
    """Escape ("rope") pointer for every BVH node.

    escape[i] is the node a depth-first traversal jumps to when it
    skips or finishes node i: the next sibling, or the closest
    ancestor's next sibling, or ESCAPE_SENTINEL at the end.  With these
    the traversal needs no per-ray stack — the single hottest state
    reduction for the lock-step walker (see chroma_jax/ops/mesh.py).

    Children of a node are contiguous (BVH layout invariant), so the
    pointers follow from a breadth-wise sweep: each round assigns all
    children of parents whose own escape is already known (~tree-depth
    rounds, fully vectorized).
    """
    n = len(nodes_arr)
    w = nodes_arr[:, 3]
    nchild = (w >> np.uint32(28)).astype(np.int64)
    first_child = (w & np.uint32(0x0FFFFFFF)).astype(np.int64)

    escape = np.full(n, ESCAPE_SENTINEL, dtype=np.uint32)
    known = np.zeros(n, dtype=bool)
    known[0] = True
    done = np.zeros(n, dtype=bool)
    internal = nchild > 0

    from chroma_jax.bvh.build import _intra_run

    for _ in range(64):
        ready = np.flatnonzero(internal & known & ~done)
        if len(ready) == 0:
            break
        done[ready] = True
        k = nchild[ready]
        c0 = first_child[ready]
        child_ids = np.repeat(c0, k) + _intra_run(k)
        # next sibling by default ...
        esc = (child_ids + 1).astype(np.uint32)
        # ... but the last child inherits the parent's escape
        last = np.cumsum(k) - 1
        esc[last] = escape[ready]
        escape[child_ids] = esc
        known[child_ids] = True
    return escape


# geometries beyond this triangle count only ship the MBVH (the
# narrow escape-rope walker tables would cost ~65 B/triangle of device
# memory
# and are only used for validation on small meshes)
LEGACY_WALKER_MAX_TRIANGLES = 2_000_000


def pack_geometry(geometry, wavelengths=None, times=None,
                  include_legacy_bvh=None, instancing=None):
    """Pack a flattened Geometry into GeometryTables.

    ``instancing``: True/False forces the TLAS/BLAS instanced MBVH on
    or off; None (default) decides automatically.  The legacy packed
    BVH (escape-rope validation walker) additionally requires
    ``geometry.bvh``; the MBVH does not."""
    if wavelengths is None:
        wavelengths = standard_wavelengths
    def uniform_step(grid, what):
        step = (float(grid[-1]) - float(grid[0])) / (len(grid) - 1)
        if not np.allclose(np.diff(grid), step, rtol=1e-3,
                           atol=abs(step) * 1e-3):
            raise ValueError('%s must be equally spaced apart.' % what)
        return step

    wavelengths = np.asarray(wavelengths, dtype=np.float32)
    wavelength_step = uniform_step(wavelengths, 'wavelengths')

    if times is None:
        times = DEFAULT_TIME_GRID
    times = np.asarray(times, dtype=np.float32)
    time_step = uniform_step(times, 'times')

    W = len(wavelengths)
    Tn = len(times)

    # ---- materials -------------------------------------------------
    materials = geometry.unique_materials
    M = len(materials)
    max_comp = max([len(m.comp_reemission_prob) for m in materials] + [1])

    refractive_index = np.ones((M, W), dtype=np.float32)
    absorption_length = np.full((M, W), 1e30, dtype=np.float32)
    scattering_length = np.full((M, W), 1e30, dtype=np.float32)
    num_comp = np.zeros(M, dtype=np.int32)
    comp_prob = np.zeros((M, max_comp, W), dtype=np.float32)
    comp_wvl_cdf = np.zeros((M, max_comp, W), dtype=np.float32)
    comp_time_cdf = np.zeros((M, max_comp, Tn), dtype=np.float32)
    comp_abs = np.full((M, max_comp, W), 1e30, dtype=np.float32)

    for i, mat in enumerate(materials):
        if mat is None:
            raise Exception('one or more triangles is missing a material.')
        refractive_index[i] = interp_material_property(
            wavelengths, mat.refractive_index)
        absorption_length[i] = interp_material_property(
            wavelengths, mat.absorption_length)
        scattering_length[i] = interp_material_property(
            wavelengths, mat.scattering_length)
        nc = len(mat.comp_reemission_prob)
        assert nc == len(mat.comp_reemission_wvl_cdf) \
            == len(mat.comp_reemission_time_cdf) \
            == len(mat.comp_absorption_length), \
            'component arrays must be same length'
        num_comp[i] = nc
        for c in range(nc):
            comp_prob[i, c] = interp_material_property(
                wavelengths, mat.comp_reemission_prob[c])
            comp_wvl_cdf[i, c] = interp_material_property(
                wavelengths, mat.comp_reemission_wvl_cdf[c])
            comp_time_cdf[i, c] = interp_material_property(
                times, mat.comp_reemission_time_cdf[c])
            comp_abs[i, c] = interp_material_property(
                wavelengths, mat.comp_absorption_length[c])

    # ---- surfaces --------------------------------------------------
    surfaces = geometry.unique_surfaces
    S = max(len(surfaces), 1)
    surf = {name: np.zeros((S, W), dtype=np.float32)
            for name in ['detect', 'absorb', 'reemit', 'reflect_diffuse',
                         'reflect_specular', 'eta', 'k', 'reemission_cdf']}
    surf_model = np.zeros(S, dtype=np.int32)
    surf_transmissive = np.zeros(S, dtype=np.int32)
    surf_thickness = np.zeros(S, dtype=np.float32)

    max_angles = 2
    for s in surfaces:
        if s is not None and s.dichroic_props is not None:
            max_angles = max(max_angles, len(s.dichroic_props.angles))
    dich_angles = np.zeros((S, max_angles), dtype=np.float32)
    dich_nangles = np.zeros(S, dtype=np.int32)
    dich_reflect = np.zeros((S, max_angles, W), dtype=np.float32)
    dich_transmit = np.zeros((S, max_angles, W), dtype=np.float32)

    for i, s in enumerate(surfaces):
        if s is None:
            continue
        for name in surf:
            surf[name][i] = interp_material_property(wavelengths,
                                                     getattr(s, name))
        surf_model[i] = s.model
        surf_transmissive[i] = s.transmissive
        surf_thickness[i] = s.thickness
        if s.dichroic_props is not None:
            dp = s.dichroic_props
            na = len(dp.angles)
            dich_nangles[i] = na
            dich_angles[i, :na] = dp.angles
            for a in range(na):
                dich_reflect[i, a] = interp_material_property(
                    wavelengths, dp.dichroic_reflect[a])
                dich_transmit[i, a] = interp_material_property(
                    wavelengths, dp.dichroic_transmit[a])

    # ---- inverse CDF tables ----------------------------------------
    comp_wvl_icdf = np.zeros((M, max_comp, N_ICDF), dtype=np.float32)
    comp_time_icdf = np.zeros((M, max_comp, N_ICDF), dtype=np.float32)
    for i in range(M):
        for c in range(int(num_comp[i])):
            comp_wvl_icdf[i, c] = inverse_cdf(wavelengths, comp_wvl_cdf[i, c])
            comp_time_icdf[i, c] = inverse_cdf(times, comp_time_cdf[i, c])
    surf_icdf = np.zeros((S, N_ICDF), dtype=np.float32)
    for i in range(S):
        surf_icdf[i] = inverse_cdf(wavelengths, surf['reemission_cdf'][i])

    # ---- triangle material codes (reference ABI) ---------------------
    material_codes = ((geometry.inner_material_index.astype(np.uint32)
                       << np.uint32(24))
                      | (geometry.outer_material_index.astype(np.uint32)
                         << np.uint32(16))
                      | ((geometry.surface_index.astype(np.uint32)
                          & np.uint32(0xFF)) << np.uint32(8)))

    bvh = geometry.bvh
    solid_id_map = geometry.solid_id.astype(np.int32)

    if include_legacy_bvh is None:
        include_legacy_bvh = (bvh is not None
                              and len(geometry.mesh.triangles)
                              <= LEGACY_WALKER_MAX_TRIANGLES)
    if include_legacy_bvh:
        if bvh is None:
            raise ValueError('geometry has no BVH; call '
                             'chroma_jax.loader.create_geometry_from_obj')
        nodes_arr = from_uint4(bvh.nodes)
        escape = compute_escape_pointers(nodes_arr)
        tri_vertices = geometry.mesh.vertices[geometry.mesh.triangles]
    else:
        nodes_arr = np.zeros((1, 4), dtype=np.uint32)
        escape = np.zeros(1, dtype=np.uint32)
        tri_vertices = np.zeros((1, 3, 3), dtype=np.float32)

    mbvh = _load_or_build_mbvh(geometry, material_codes,
                               instancing=instancing)
    from chroma_jax.ops.mbvh import MAX_LEVELS
    if mbvh.depth > MAX_LEVELS:
        raise ValueError('MBVH needs %d levels > walker MAX_LEVELS=%d'
                         % (mbvh.depth, MAX_LEVELS))

    return GeometryTables(
        vertices=jnp.asarray(geometry.mesh.vertices, dtype=jnp.float32),
        triangles=jnp.asarray(geometry.mesh.triangles, dtype=jnp.int32),
        tri_vertices=jnp.asarray(tri_vertices, dtype=jnp.float32),
        material_codes=jnp.asarray(material_codes),
        colors=jnp.asarray(geometry.colors.astype(np.uint32)),
        solid_id_map=jnp.asarray(solid_id_map),
        nodes=jnp.asarray(nodes_arr),
        escape=jnp.asarray(escape),
        mbvh_rows=jnp.asarray(mbvh.rows),
        mbvh_depth=int(mbvh.depth),
        mbvh_instanced=bool(getattr(mbvh, 'instanced', False)),
        world_origin=jnp.asarray(mbvh.world_coords.world_origin),
        world_scale=jnp.asarray(mbvh.world_coords.world_scale),
        legacy_world_origin=jnp.asarray(
            bvh.world_coords.world_origin if bvh is not None
            else mbvh.world_coords.world_origin),
        legacy_world_scale=jnp.asarray(
            bvh.world_coords.world_scale if bvh is not None
            else mbvh.world_coords.world_scale),
        refractive_index=jnp.asarray(refractive_index),
        absorption_length=jnp.asarray(absorption_length),
        scattering_length=jnp.asarray(scattering_length),
        num_comp=jnp.asarray(num_comp),
        comp_reemission_prob=jnp.asarray(comp_prob),
        comp_reemission_wvl_cdf=jnp.asarray(comp_wvl_cdf),
        comp_reemission_time_cdf=jnp.asarray(comp_time_cdf),
        comp_absorption_length=jnp.asarray(comp_abs),
        surf_detect=jnp.asarray(surf['detect']),
        surf_absorb=jnp.asarray(surf['absorb']),
        surf_reemit=jnp.asarray(surf['reemit']),
        surf_reflect_diffuse=jnp.asarray(surf['reflect_diffuse']),
        surf_reflect_specular=jnp.asarray(surf['reflect_specular']),
        surf_eta=jnp.asarray(surf['eta']),
        surf_k=jnp.asarray(surf['k']),
        surf_reemission_cdf=jnp.asarray(surf['reemission_cdf']),
        surf_model=jnp.asarray(surf_model),
        surf_transmissive=jnp.asarray(surf_transmissive),
        surf_thickness=jnp.asarray(surf_thickness),
        dichroic_angles=jnp.asarray(dich_angles),
        dichroic_nangles=jnp.asarray(dich_nangles),
        dichroic_reflect=jnp.asarray(dich_reflect),
        dichroic_transmit=jnp.asarray(dich_transmit),
        comp_reemission_wvl_icdf=jnp.asarray(comp_wvl_icdf),
        comp_reemission_time_icdf=jnp.asarray(comp_time_icdf),
        surf_reemission_icdf=jnp.asarray(surf_icdf),
        wavelength0=float(wavelengths[0]),
        wavelength_step=wavelength_step,
        nwavelengths=W,
        time0=float(times[0]),
        time_step=time_step,
        ntimes=Tn,
        nu=N_ICDF,
        has_reemission=bool((num_comp > 0).any()),
        has_surfaces=bool((geometry.surface_index >= 0).any()),
        has_complex=bool((surf_model == 1).any()),
        has_wls=bool((surf_model == 2).any()),
        has_dichroic=bool((surf_model == 3).any()),
        max_comp=max_comp,
    )


def pack_detector(detector, wavelengths=None, times=None):
    """(GeometryTables, DetectorTables) for a flattened Detector."""
    geom = pack_geometry(detector, wavelengths=wavelengths, times=times)
    det = DetectorTables(
        solid_id_to_channel_index=jnp.asarray(
            np.asarray(detector.solid_id_to_channel_index, dtype=np.int32)),
        time_cdf_x=jnp.asarray(detector.time_cdf[0], dtype=jnp.float32),
        time_cdf_y=jnp.asarray(detector.time_cdf[1], dtype=jnp.float32),
        charge_cdf_x=jnp.asarray(detector.charge_cdf[0], dtype=jnp.float32),
        charge_cdf_y=jnp.asarray(detector.charge_cdf[1], dtype=jnp.float32),
        time_icdf=jnp.asarray(inverse_cdf(detector.time_cdf[0],
                                          detector.time_cdf[1])),
        charge_icdf=jnp.asarray(inverse_cdf(detector.charge_cdf[0],
                                            detector.charge_cdf[1])),
        # same quantization convention as the reference DAQ
        # (chroma/gpu/detector.py: charge_cdf_x[-1] / 2**16)
        charge_unit=jnp.float32(detector.charge_cdf[0][-1] / 2 ** 16),
        nchannels=int(detector.num_channels()),
    )
    return geom, det


def interp_property(tables, table, material_index, wavelength):
    """Per-photon lookup of a (M,W) wavelength table at (index, lambda).

    Uniform-grid clamp + lerp (reference: chroma/cuda/geometry.h:62).
    ``table`` may also be (M,C,W) with a composite leading index."""
    w0 = tables.wavelength0
    dw = tables.wavelength_step
    n = tables.nwavelengths
    x = (wavelength - w0) / dw
    x = jnp.clip(x, 0.0, n - 1.0)
    jl = jnp.clip(x.astype(jnp.int32), 0, n - 2)
    f = x - jl
    lo = table[material_index, jl]
    hi = table[material_index, jl + 1]
    return lo + (hi - lo) * f
