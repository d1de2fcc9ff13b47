"""Native constructive solid geometry on triangle meshes.

The reference meshes GDML boolean solids through gmsh/OpenCASCADE
(reference: chroma/rat/gen_mesh.py:56 gdml_boolean).  gmsh is an
optional heavyweight dependency; this module provides a dependency
-free fallback: the classic BSP-tree polygon clipping algorithm
(Thibault & Naylor style, as popularized by csg.js) operating directly
on closed triangle meshes.

Suitable for the solid sizes that appear in GDML files (primitives of
10^2..10^4 triangles).  All inputs must be closed, consistently-wound
(outward normals) meshes — which the GDML primitive builders produce.
"""
import numpy as np

EPSILON = 1e-6

_COPLANAR, _FRONT, _BACK, _SPANNING = 0, 1, 2, 3


class _Polygon(object):
    __slots__ = ('verts', 'normal', 'w')

    def __init__(self, verts, normal=None, w=None):
        self.verts = verts
        if normal is None:
            a, b, c = verts[0], verts[1], verts[2]
            n = np.cross(b - a, c - a)
            ln = np.linalg.norm(n)
            normal = n / ln if ln > 0 else n
            w = float(np.dot(normal, a))
        self.normal = normal
        self.w = w

    def flip(self):
        return _Polygon(self.verts[::-1], -self.normal, -self.w)

    def clone(self):
        return _Polygon(list(self.verts), self.normal, self.w)


def _split_polygon(normal, w, poly, coplanar_front, coplanar_back,
                   front, back):
    """Classify/split ``poly`` against the plane (normal, w)."""
    types = []
    ptype = 0
    for v in poly.verts:
        t = np.dot(normal, v) - w
        typ = _BACK if t < -EPSILON else (_FRONT if t > EPSILON
                                          else _COPLANAR)
        ptype |= typ
        types.append(typ)

    if ptype == _COPLANAR:
        (coplanar_front if np.dot(normal, poly.normal) > 0
         else coplanar_back).append(poly)
    elif ptype == _FRONT:
        front.append(poly)
    elif ptype == _BACK:
        back.append(poly)
    else:
        f, b = [], []
        n = len(poly.verts)
        for i in range(n):
            j = (i + 1) % n
            ti, tj = types[i], types[j]
            vi, vj = poly.verts[i], poly.verts[j]
            if ti != _BACK:
                f.append(vi)
            if ti != _FRONT:
                b.append(vi)
            if (ti | tj) == _SPANNING:
                t = (w - np.dot(normal, vi)) / np.dot(normal, vj - vi)
                v = vi + t * (vj - vi)
                f.append(v)
                b.append(v)
        if len(f) >= 3:
            front.append(_Polygon(f, poly.normal, poly.w))
        if len(b) >= 3:
            back.append(_Polygon(b, poly.normal, poly.w))


class _BSPNode(object):
    __slots__ = ('normal', 'w', 'front', 'back', 'polygons')

    def __init__(self, polygons=None):
        self.normal = None
        self.front = None
        self.back = None
        self.polygons = []
        if polygons:
            self.build(polygons)

    def build(self, polygons):
        # iterative (stack) build: GDML solids can be deep
        stack = [(self, polygons)]
        while stack:
            node, polys = stack.pop()
            if not polys:
                continue
            if node.normal is None:
                node.normal = polys[0].normal
                node.w = polys[0].w
            front, back = [], []
            for p in polys:
                _split_polygon(node.normal, node.w, p, node.polygons,
                               node.polygons, front, back)
            if front:
                if node.front is None:
                    node.front = _BSPNode()
                stack.append((node.front, front))
            if back:
                if node.back is None:
                    node.back = _BSPNode()
                stack.append((node.back, back))

    def invert(self):
        stack = [self]
        while stack:
            node = stack.pop()
            node.polygons = [p.flip() for p in node.polygons]
            if node.normal is not None:
                node.normal = -node.normal
                node.w = -node.w
            node.front, node.back = node.back, node.front
            if node.front:
                stack.append(node.front)
            if node.back:
                stack.append(node.back)

    def clip_polygons(self, polygons):
        """Remove parts of ``polygons`` inside this BSP's solid."""
        out = []
        stack = [(self, polygons)]
        while stack:
            node, polys = stack.pop()
            if node.normal is None:
                out.extend(polys)
                continue
            front, back = [], []
            for p in polys:
                _split_polygon(node.normal, node.w, p, front, back,
                               front, back)
            if node.front:
                stack.append((node.front, front))
            else:
                out.extend(front)
            if node.back:
                stack.append((node.back, back))
            # polygons in back of a leaf plane are inside: dropped
        return out

    def clip_to(self, bsp):
        stack = [self]
        while stack:
            node = stack.pop()
            node.polygons = bsp.clip_polygons(node.polygons)
            if node.front:
                stack.append(node.front)
            if node.back:
                stack.append(node.back)

    def all_polygons(self):
        out = []
        stack = [self]
        while stack:
            node = stack.pop()
            out.extend(node.polygons)
            if node.front:
                stack.append(node.front)
            if node.back:
                stack.append(node.back)
        return out


def _mesh_to_polygons(mesh):
    tv = mesh.vertices[mesh.triangles].astype(np.float64)
    polys = []
    for tri in tv:
        a, b, c = tri
        n = np.cross(b - a, c - a)
        ln = np.linalg.norm(n)
        if ln < 1e-30:
            continue
        polys.append(_Polygon([a, b, c], n / ln,
                              float(np.dot(n / ln, a))))
    return polys


def _polygons_to_mesh(polygons):
    from chroma_jax.geometry import Mesh
    tris = []
    for p in polygons:
        v = p.verts
        for i in range(1, len(v) - 1):      # fan triangulation
            tris.append((v[0], v[i], v[i + 1]))
    if not tris:
        return Mesh(np.zeros((3, 3)), np.array([[0, 1, 2]]),
                    remove_duplicate_vertices=False,
                    remove_null_triangles=False)
    tv = np.asarray(tris, dtype=np.float64)
    verts = tv.reshape(-1, 3)
    faces = np.arange(len(verts)).reshape(-1, 3)
    return Mesh(verts, faces, remove_duplicate_vertices=True,
                remove_null_triangles=True)


_OP_CODES = {'union': 0, 'subtraction': 1, 'intersection': 2}


def boolean(op, mesh_a, mesh_b):
    """CSG boolean of two closed meshes: op in
    ('union', 'subtraction', 'intersection').  Uses the native C++
    backend (csrc/chroma_native.cc csg_boolean) when available; the
    Python BSP below is the dependency-free fallback."""
    from chroma_jax import native
    if op not in _OP_CODES:
        raise ValueError('unknown boolean op %r' % (op,))
    out = native.csg_boolean(
        _OP_CODES[op],
        mesh_a.vertices[mesh_a.triangles].astype(np.float64),
        mesh_b.vertices[mesh_b.triangles].astype(np.float64))
    if out is not None:
        from chroma_jax.geometry import Mesh
        verts = out.reshape(-1, 3)
        faces = np.arange(len(verts)).reshape(-1, 3)
        return Mesh(verts, faces, remove_duplicate_vertices=True,
                    remove_null_triangles=True)
    return _boolean_python(op, mesh_a, mesh_b)


def _boolean_python(op, mesh_a, mesh_b):
    a = _BSPNode(_mesh_to_polygons(mesh_a))
    b = _BSPNode(_mesh_to_polygons(mesh_b))

    if op == 'union':
        a.clip_to(b)
        b.clip_to(a)
        b.invert()
        b.clip_to(a)
        b.invert()
        return _polygons_to_mesh(a.all_polygons() + b.all_polygons())
    if op == 'subtraction':
        a.invert()
        a.clip_to(b)
        b.clip_to(a)
        b.invert()
        b.clip_to(a)
        b.invert()
        a.invert()
        # the retained piece of B's surface bounds a cavity in A: its
        # normals must point out of A-B, i.e. into B
        return _polygons_to_mesh(a.all_polygons()
                                 + [p.flip() for p in b.all_polygons()])
    if op == 'intersection':
        a.invert()
        b.clip_to(a)
        b.invert()
        a.clip_to(b)
        b.clip_to(a)
        a.invert()
        b.invert()
        return _polygons_to_mesh(a.all_polygons() + b.all_polygons())
    raise ValueError('unknown boolean op %r' % (op,))


def union(a, b):
    return boolean('union', a, b)


def subtract(a, b):
    return boolean('subtraction', a, b)


def intersect(a, b):
    return boolean('intersection', a, b)
