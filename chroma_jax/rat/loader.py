"""GDML -> Detector loader (parity subset of chroma/rat/loader.py).

Parses a GDML file directly (xml.etree), builds the volume hierarchy
with absolute placements, meshes each volume's solid with the native
primitive generators (chroma_jax/rat/gdml.py) and assembles a Detector.

Architectural difference vs the reference: the reference pushes every
solid through the gmsh OCC kernel and conformally meshes shared
boundaries, assigning per-face materials from boundary analysis
(reference: chroma/rat/loader.py:370 retrieve_mesh, :494
assign_surface_properties).  Here each volume is meshed
independently (triangles get inner=volume material / outer=parent
material — the classic Chroma geometry model), then a conformal
pass detects triangles coincident between touching volumes (the
native meshers tessellate matching profiles identically), keeps each
shared face exactly once on the deepest volume with outer material
taken from the far side, and applies GDML border surfaces
(``bordersurface``) both to whole child/parent interfaces and to
deduplicated shared faces.  Boolean solids use the native BSP CSG.
"""
from collections import deque

import numpy as np
import xml.etree.ElementTree as et

from chroma_jax.rat import gdml
from chroma_jax.geometry import Mesh, Solid, vacuum, _unique_objects
from chroma_jax.detector import Detector
from chroma_jax.transform import make_rotation_matrix
from chroma_jax.log import logger

DEFAULT_SOLID_COLOR = 0xEEA0A0A0
DEFAULT_PMT_COLOR = 0xA0A05000

# meshers for the GDML primitive solids (chroma_jax/rat/gdml.py);
# boolean solids are dispatched separately onto the BSP CSG engine
_SOLID_MESHERS = {
    name: getattr(gdml, name)
    for name in ('box', 'eltube', 'ellipsoid', 'orb', 'polycone',
                 'polyhedra', 'sphere', 'torus', 'tube', 'torusstack')
}
_BOOLEAN_TAGS = ('union', 'subtraction', 'intersection')


def _euler_xyz(angles):
    """GDML rotation (x, y, z Euler angles) -> 3x3 matrix."""
    rx = make_rotation_matrix(angles[0], [1, 0, 0])
    ry = make_rotation_matrix(angles[1], [0, 1, 0])
    rz = make_rotation_matrix(angles[2], [0, 0, 1])
    return rx @ ry @ rz


def _default_volume_classifier(volume_ref, material_ref,
                               parent_material_ref):
    """Example classifier: ('pmt'|'solid'|'omit', Solid kwargs)."""
    if 'OpDetSensitive' in volume_ref:
        return 'pmt', dict(color=DEFAULT_PMT_COLOR, surface=None,
                           channel_type=0)
    if material_ref == parent_material_ref:
        return 'omit', {}
    return 'solid', dict(color=DEFAULT_SOLID_COLOR, surface=None)


class Volume:
    """One placed GDML logical volume, with its absolute transform.

    Instances form a tree rooted at the world volume; ``placement`` is
    the /-joined chain of physvol names from the root (the key RAT
    border surfaces are declared against).
    """

    __slots__ = ('name', 'placement', 'material_ref',
                 'parent_material_ref', 'solid_ref', 'absolute_pos',
                 'absolute_rot', 'children', 'mesh', 'pmt_type',
                 'pmt_channel')

    def __init__(self, name, volume_xml, placement='/BUILDROOT',
                 parent_material_ref=None, absolute_pos=None,
                 absolute_rot=None):
        self.name = name
        self.placement = placement
        self.material_ref = volume_xml.find('materialref').get('ref')
        self.solid_ref = volume_xml.find('solidref').get('ref')
        self.parent_material_ref = parent_material_ref
        self.absolute_pos = (np.zeros(3) if absolute_pos is None
                             else np.asarray(absolute_pos, dtype=float))
        self.absolute_rot = (np.identity(3) if absolute_rot is None
                             else np.asarray(absolute_rot, dtype=float))
        self.children = []
        self.mesh = None
        self.pmt_type = None
        self.pmt_channel = None

    # backwards-compatible aliases for the reference API names
    @property
    def placementName(self):                               # noqa: N802
        return self.placement

    def walk(self):
        """Yield this volume and every descendant (preorder)."""
        stack = [self]
        while stack:
            volume = stack.pop()
            yield volume
            stack.extend(volume.children)

    def flat_view(self):
        """{placement path: Volume} over the whole subtree."""
        return {v.placement: v for v in self.walk()}

    def show_hierarchy(self, indent=''):
        print(indent + self.name, self.solid_ref, self.material_ref)
        for child in self.children:
            child.show_hierarchy(indent=indent + ' ')

    def __str__(self):
        return self.name

    __repr__ = __str__


def _build_volume_tree(loader, world_ref):
    """Instantiate the Volume tree from the GDML structure section,
    resolving each physvol's transform to absolute coordinates."""
    root = Volume(world_ref, loader.vol_xml_map[world_ref])
    todo = deque([root])
    while todo:
        parent = todo.popleft()
        for pv in loader.vol_xml_map[parent.name].findall('physvol'):
            pos_xml, rot_xml = loader.get_pos_rot(pv)
            local_pos = (gdml.get_vals(pos_xml)
                         if pos_xml is not None else np.zeros(3))
            local_rot = (_euler_xyz(gdml.get_vals(rot_xml))
                         if rot_xml is not None else np.identity(3))
            child = Volume(
                pv.find('volumeref').get('ref'),
                loader.vol_xml_map[pv.find('volumeref').get('ref')],
                placement='%s/%s' % (parent.placement, pv.get('name')),
                parent_material_ref=parent.material_ref,
                absolute_pos=(parent.absolute_rot @ local_pos
                              + parent.absolute_pos),
                absolute_rot=parent.absolute_rot @ local_rot)
            parent.children.append(child)
            todo.append(child)
    return root


class RATGeoLoader:
    """Builds a chroma_jax Detector from a GDML file (+ optional
    RATDB channel info)."""

    def __init__(self, gdml_file, refinement_order=0, ratdb_file=None,
                 override_worldref=None, outside_material_ref=None):
        self.nPMTs = 0
        self.pmt_index_to_position = None
        self.pmt_index_to_type = None
        self.ratdb_parser = None
        if ratdb_file is not None:
            self.add_ratdb(ratdb_file)
        else:
            logger.warning('No RATDB file provided; no PMT channel info '
                           'will be loaded.')

        self.refinement_order = refinement_order
        self.gdml_file = gdml_file
        root_xml = et.parse(gdml_file).getroot()
        self._parse_defines(root_xml.find('define'))
        self._parse_materials(root_xml.find('materials'))
        self._parse_solids(root_xml.find('solids'))
        self._parse_structure(root_xml.find('structure'))

        world_ref = root_xml.find('setup').find('world').get('ref')
        if override_worldref is not None:
            world_ref = override_worldref
        self.world = _build_volume_tree(self, world_ref)
        self.placement_to_volume_map = self.world.flat_view()
        self.outside_material_ref = outside_material_ref
        self._ignore_solid = lambda _: False

    # ---- GDML section parsers ----------------------------------------

    def _parse_defines(self, define_xml):
        self.pos_map = {e.get('name'): e
                        for e in define_xml.findall('position')}
        self.rot_map = {e.get('name'): e
                        for e in define_xml.findall('rotation')}
        self.matrix_map = {e.get('name'): e
                           for e in define_xml.findall('matrix')}
        self.vertex_positions = {
            e.get('name'): gdml.get_vals(e, unit_attr='unit')
            for e in define_xml.findall('position')}

    def _parse_materials(self, materials_xml):
        self.materials_used = []
        self.material_lookup = {}
        for mat_xml in materials_xml:
            if mat_xml.tag != 'material':
                continue
            self.material_lookup[mat_xml.get('name')] = \
                len(self.materials_used)
            self.materials_used.append(
                gdml.create_material(self.matrix_map, mat_xml))

    def _parse_solids(self, solids_xml):
        self.solid_xml_map = {e.get('name'): e for e in solids_xml}
        self.surfaces_used = [None]
        self.surface_lookup = {None: None}
        for surf_xml in solids_xml.findall('opticalsurface'):
            surface = gdml.create_surface(self.matrix_map, surf_xml)
            self.surfaces_used.append(surface)
            self.surface_lookup[surf_xml.get('name')] = surface

    def _parse_structure(self, structure_xml):
        self.vol_xml_map = {e.get('name'): e
                            for e in structure_xml.findall('volume')}
        # skin surfaces: apply to every face of the named volume
        self.skin_surface_map = {
            e.find('volumeref').get('ref'):
                self.surface_lookup.get(e.get('surfaceproperty'))
            for e in structure_xml.findall('skinsurface')}
        # border surfaces: apply to photons crossing between a specific
        # pair of physical volumes (reference: chroma/rat/loader.py:537)
        self.border_surfaces = []
        for e in structure_xml.findall('bordersurface'):
            pair = [pv.get('ref') for pv in e.findall('physvolref')]
            surface = self.surface_lookup.get(e.get('surfaceproperty'))
            if len(pair) == 2 and surface is not None:
                self.border_surfaces.append(
                    (frozenset(pair), surface))

    # ---- loader plumbing ----------------------------------------------

    def add_ratdb(self, ratdb_file):
        from chroma_jax.rat.ratdb_parser import RatDBParser
        self.ratdb_parser = RatDBParser(ratdb_file)

    def get_pos_rot(self, elem, refs=('position', 'rotation')):
        """Inline or referenced <position>/<rotation> of an element."""
        found = []
        for tag, table in zip(refs, (self.pos_map, self.rot_map)):
            node = elem.find(tag)
            if node is None:
                ref = elem.find(tag + 'ref')
                node = table[ref.get('ref')] if ref is not None else None
            found.append(node)
        return tuple(found)

    def _border_surface_for(self, pv_a, pv_b):
        """Border surface declared between two physical volume names."""
        want = frozenset((pv_a, pv_b))
        for pair, surface in self.border_surfaces:
            if pair == want:
                return surface
        return None

    @staticmethod
    def _pv_name(placement):
        return placement.rsplit('/', 1)[-1]

    # ---- solid meshing --------------------------------------------------

    def build_mesh(self, solid_ref):
        """Mesh for the named solid (primitives native; boolean solids
        via chroma_jax.csg)."""
        if self._ignore_solid(solid_ref):
            logger.info('Ignoring solid: %s', solid_ref)
            return None
        elem = self.solid_xml_map[solid_ref]
        tag = elem.tag
        if tag in _BOOLEAN_TAGS:
            return self._boolean_mesh(elem, tag)
        if tag == 'tessellated':
            return gdml.tessellated(elem, self.vertex_positions)
        if tag == 'opticalsurface':
            return None
        mesher = _SOLID_MESHERS.get(tag)
        if mesher is None:
            return gdml.unsupported(elem)
        return mesher(elem)

    def _boolean_mesh(self, elem, op):
        """Boolean solid via native BSP CSG (chroma_jax/csg.py; the
        reference routes these through gmsh/OCC — rat/gen_mesh.py:56).
        The GDML transform applies to the second solid."""
        from chroma_jax import csg

        def placed(mesh, pos_xml, rot_xml):
            if mesh is None:
                return None
            verts = mesh.vertices
            if rot_xml is not None:
                verts = np.inner(verts,
                                 _euler_xyz(gdml.get_vals(rot_xml)))
            if pos_xml is not None:
                verts = verts + np.asarray(gdml.get_vals(pos_xml),
                                           dtype=float)
            if verts is mesh.vertices:
                return mesh
            return Mesh(verts, mesh.triangles,
                        remove_duplicate_vertices=False,
                        remove_null_triangles=False)

        first = placed(self.build_mesh(elem.find('first').get('ref')),
                       *self.get_pos_rot(
                           elem, refs=('firstposition', 'firstrotation')))
        second = placed(self.build_mesh(elem.find('second').get('ref')),
                        *self.get_pos_rot(elem))
        if first is None or second is None:
            return first if second is None else second
        return csg.boolean(op, first, second)

    # ---- detector assembly ----------------------------------------------

    def build_detector(self, detector=None,
                       volume_classifier=_default_volume_classifier,
                       solids_to_ignore=None, no_union=None,
                       conformal=True):
        """Assemble a Detector from the volume hierarchy.

        With ``conformal=True`` (default), triangles coincident between
        touching volumes are deduplicated: each shared face is kept once
        on the deepest volume, its outer material is the far side's
        outer material, and declared ``bordersurface`` properties are
        applied (reference: chroma/rat/loader.py:494
        assign_surface_properties via gmsh conformal meshing).
        """
        if detector is None:
            detector = Detector(vacuum)
        if solids_to_ignore is not None:
            self._ignore_solid = solids_to_ignore

        records = [rec for rec in
                   (self._solid_record(v, volume_classifier)
                    for v in self.world.walk())
                   if rec is not None]
        if conformal and len(records) > 1:
            self._conform(records)

        for rec in records:
            if rec['classification'] == 'pmt':
                detector.add_pmt(rec['solid'],
                                 channel_type=rec['channel_type'],
                                 displacement=None)
            elif rec['classification'] == 'solid':
                detector.add_solid(rec['solid'])
            else:
                raise Exception('Unknown volume classification: %r'
                                % rec['classification'])
        return detector

    def _solid_record(self, volume, volume_classifier):
        """Classify + mesh one volume; None if omitted/unmeshable."""
        classification, kwargs = volume_classifier(
            volume.name, volume.material_ref,
            volume.parent_material_ref)
        if classification == 'omit':
            return None
        mesh = self.build_mesh(volume.solid_ref)
        if mesh is None:
            return None
        mesh.vertices = (np.inner(mesh.vertices, volume.absolute_rot)
                         + volume.absolute_pos)
        volume.mesh = mesh

        inner = self.materials_used[
            self.material_lookup[volume.material_ref]]
        outer_ref = (volume.parent_material_ref
                     or self.outside_material_ref
                     or volume.material_ref)
        outer = self.materials_used[self.material_lookup[outer_ref]]

        surface = kwargs.pop('surface', None)
        if surface is None:
            surface = self.skin_surface_map.get(volume.name)
        if surface is None and '/' in volume.placement[1:]:
            # whole child/parent interface border surface
            parent_placement = volume.placement.rsplit('/', 1)[0]
            surface = self._border_surface_for(
                self._pv_name(volume.placement),
                self._pv_name(parent_placement))
        color = kwargs.pop('color', DEFAULT_SOLID_COLOR)
        channel_type = kwargs.pop('channel_type', None)
        kwargs.pop('material1', None)
        kwargs.pop('material2', None)
        if classification == 'pmt' and volume.pmt_channel is not None:
            channel_type = volume.pmt_type

        return dict(volume=volume,
                    solid=Solid(mesh, inner, outer, surface=surface,
                                color=color),
                    classification=classification,
                    channel_type=channel_type)

    def _conform(self, records):
        """Deduplicate coincident triangles between touching volumes.

        Triangles whose three vertices agree to 0.1 um across two (or
        more) volumes are a shared boundary meshed twice.  Keep the
        deepest volume's copy, give it the shallowest volume's outer
        material (the medium actually on the far side), and resolve its
        surface as: declared border surface between the two placements,
        else the kept triangle's surface, else any dropped triangle's
        surface (e.g. the parent's skin).  Mirrors the boundary
        analysis of the reference's conformal gmsh pipeline
        (chroma/rat/loader.py:370,:494) without an OCC kernel.
        """
        vert_dt = np.dtype([('x', 'i8'), ('y', 'i8'), ('z', 'i8')])
        tri_dt = np.dtype([('a', vert_dt), ('b', vert_dt),
                           ('c', vert_dt)])
        all_keys = []
        owner = []
        for ri, rec in enumerate(records):
            mesh = rec['solid'].mesh
            ntri = len(mesh.triangles)
            verts = mesh.vertices[mesh.triangles]  # (n, 3, 3)
            qv = np.ascontiguousarray(
                np.round(verts * 1e4).astype(np.int64)
            ).view(vert_dt).reshape(ntri, 3)
            qv.sort(axis=1)
            all_keys.append(qv.view(tri_dt).reshape(ntri))
            owner.append(np.stack(
                [np.full(ntri, ri), np.arange(ntri)], axis=1))
        keys = np.concatenate(all_keys)
        owner = np.concatenate(owner)
        _, inverse, counts = np.unique(keys, return_inverse=True,
                                       return_counts=True)
        dup_groups = {}
        for flat_idx in np.nonzero(counts[inverse] >= 2)[0]:
            dup_groups.setdefault(inverse[flat_idx], []).append(
                tuple(owner[flat_idx]))

        drop = [np.zeros(len(k), dtype=bool) for k in all_keys]
        n_shared = 0
        for entries in dup_groups.values():
            if len({ri for ri, _ in entries}) < 2:
                continue  # duplicate within one solid: leave alone
            n_shared += 1
            depth = [records[ri]['volume'].placement.count('/')
                     for ri, _ in entries]
            order = np.argsort(depth)[::-1]
            keep_ri, keep_ti = entries[order[0]]
            far_ri, far_ti = entries[order[-1]]
            keep_solid = records[keep_ri]['solid']
            keep_solid.outer_material[keep_ti] = \
                records[far_ri]['solid'].outer_material[far_ti]
            surface = None
            keep_pv = self._pv_name(
                records[keep_ri]['volume'].placement)
            for oi in order[1:]:
                ri, ti = entries[oi]
                drop[ri][ti] = True
                if surface is None:
                    surface = self._border_surface_for(
                        keep_pv, self._pv_name(
                            records[ri]['volume'].placement))
            if surface is None and keep_solid.surface[keep_ti] is not None:
                surface = keep_solid.surface[keep_ti]
            if surface is None:
                for oi in order[1:]:
                    ri, ti = entries[oi]
                    s = records[ri]['solid'].surface[ti]
                    if s is not None:
                        surface = s
                        break
            keep_solid.surface[keep_ti] = surface

        if n_shared:
            logger.info('conformal pass: %d shared faces deduplicated',
                        n_shared)
        for rec, mask in zip(records, drop):
            if not mask.any():
                continue
            solid = rec['solid']
            keep = ~mask
            solid.mesh = Mesh(solid.mesh.vertices,
                              solid.mesh.triangles[keep],
                              remove_duplicate_vertices=False,
                              remove_null_triangles=False)
            for field in ('inner_material', 'outer_material',
                          'surface', 'color'):
                setattr(solid, field, getattr(solid, field)[keep])
        for rec in records:
            solid = rec['solid']
            solid.unique_materials = _unique_objects(
                list(solid.inner_material) + list(solid.outer_material))
            solid.unique_surfaces = _unique_objects(list(solid.surface))

    def add_pmt_info(self):
        """Assign PMT channels/types from RATDB GEO pmtarray tables."""
        assert self.ratdb_parser is not None, 'no RATDB loaded'
        pmt_arrays = [e for e in self.ratdb_parser.entries
                      if e.get('name') == 'GEO'
                      and e.get('type') == 'pmtarray']
        pmt_volume_names = [t['index'] + '_body_log' for t in pmt_arrays]
        pmtinfo_tables = [self.ratdb_parser.get_entry(t['pos_table'], '')
                          for t in pmt_arrays]
        pmt_positions = [np.array([t['x'], t['y'], t['z']]).T
                         for t in pmtinfo_tables]
        pmt_types = [t['type'] for t in pmtinfo_tables]

        self.nPMTs = 0
        self.pmt_index_to_type = []
        self.pmt_index_to_position = []
        for volume in self.world.walk():
            for ai, vol_name in enumerate(pmt_volume_names):
                if not volume.name.startswith(vol_name):
                    continue
                idx = np.argwhere(np.all(np.isclose(
                    volume.absolute_pos, pmt_positions[ai]), axis=1))
                assert idx.size == 1, \
                    'PMT %s not found or not unique' % volume.name
                idx = idx.item()
                volume.pmt_type = pmt_types[ai][idx]
                volume.pmt_channel = self.nPMTs
                self.pmt_index_to_type.append(volume.pmt_type)
                self.pmt_index_to_position.append(pmt_positions[ai][idx])
                self.nPMTs += 1
                break
        logger.info('Assigned %d PMT channels', self.nPMTs)

    def visualize(self, **kwargs):
        from chroma_jax.camera import view
        return view(self.build_detector(), **kwargs)
