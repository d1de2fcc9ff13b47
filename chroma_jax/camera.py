"""Geometry/event rendering: offline snapshots and an interactive
viewer (parity: chroma/camera.py).

The reference runs a pygame event loop in a forked process with the
CUDA render kernel per frame (reference: chroma/camera.py Camera).
Here rendering goes through the MBVH render op; the interactive pygame
viewer is optional (headless environments can use ``snapshot`` /
``render_to_image`` to produce PNG frames), and ``EventViewer`` colors
detector channels by charge/time from simulated events.
"""
import os

import numpy as np

from chroma_jax import gpu
from chroma_jax.ops.render import GPURays, render
from chroma_jax.tools import from_film
from chroma_jax.transform import normalize
from chroma_jax.log import logger


def pixels_to_rgb_array(pixels, size):
    """(N,) uint32 ARGB -> (height, width, 3) uint8 image array."""
    pixels = np.asarray(pixels, dtype=np.uint32)
    rgb = np.stack([(pixels >> 16) & 0xFF, (pixels >> 8) & 0xFF,
                    pixels & 0xFF], axis=-1).astype(np.uint8)
    # rays are generated pixel-major (x fastest inner loop = y)
    return rgb.reshape(size[0], size[1], 3).transpose(1, 0, 2)[::-1]


class Camera(object):
    """Renders a geometry from a movable viewpoint.

    Non-interactive use:
        cam = Camera(geometry, size=(800, 600))
        img = cam.render_to_image()           # PIL image
        cam.snapshot('out.png')
    Interactive use (needs a display): cam.run() — pygame loop with
    rotate/zoom via mouse + arrow keys.
    """

    FILM_WIDTH = 35.0
    FOCAL_LENGTH = 18.0

    def __init__(self, geometry, size=(800, 600), device_id=None,
                 alpha_depth=10):
        self.geometry = geometry
        self.size = size
        self.alpha_depth = alpha_depth

        if hasattr(geometry, 'num_channels'):
            self.gpu_geometry = gpu.GPUDetector(geometry)
        else:
            self.gpu_geometry = gpu.GPUGeometry(geometry)

        lower, upper = geometry.mesh.get_bounds()
        self.scale = np.linalg.norm(upper - lower)
        self.mesh_center = 0.5 * (lower + upper)
        self.viewpoint = self.mesh_center + \
            np.array([0.0, -self.scale, 0.0])
        self.axis1 = np.array([0.0, 0.0, 1.0])
        self.axis2 = np.array([1.0, 0.0, 0.0])
        self._update_rays()

    def _update_rays(self):
        pos, dir = from_film(self.viewpoint, axis1=self.axis1,
                             axis2=self.axis2, size=self.size,
                             width=self.FILM_WIDTH,
                             focal_length=self.FOCAL_LENGTH)
        self.rays = GPURays(pos, dir, max_alpha_depth=self.alpha_depth)

    # ---- transforms --------------------------------------------------

    def translate(self, v):
        self.viewpoint = self.viewpoint + v
        self.rays.translate(v)

    def rotate(self, phi, n):
        from chroma_jax.transform import make_rotation_matrix
        self.rays.rotate_around_point(phi, n, self.mesh_center)
        rot = make_rotation_matrix(phi, n)
        self.viewpoint = self.mesh_center \
            + np.inner(self.viewpoint - self.mesh_center, rot)
        self.axis1 = np.inner(self.axis1, rot)
        self.axis2 = np.inner(self.axis2, rot)

    # ---- overlays (photon tracks, vertices, BVH wireframe) -----------

    def project(self, points):
        """World points -> (col, row) pixel coordinates + a visibility
        mask, using the same pinhole geometry as from_film."""
        points = np.atleast_2d(np.asarray(points, dtype=float))
        normal = np.cross(self.axis1, self.axis2)
        v = points - self.viewpoint
        depth = v @ normal
        ok = depth > 1e-6
        safe = np.where(ok, depth, 1.0)
        xf = self.FOCAL_LENGTH * (v @ self.axis2) / safe
        yf = self.FOCAL_LENGTH * (v @ self.axis1) / safe
        w = self.FILM_WIDTH
        h = w * self.size[1] / float(self.size[0])
        col = (xf + w / 2.0) / w * (self.size[0] - 1)
        row = (self.size[1] - 1) - (yf + h / 2.0) / h * (self.size[1] - 1)
        return col, row, ok

    def draw_segments(self, img, starts, ends, color):
        """Rasterize world-space line segments onto an (H,W,3) image."""
        c0, r0, ok0 = self.project(starts)
        c1, r1, ok1 = self.project(ends)
        keep = ok0 & ok1
        if not keep.any():
            return img
        c0, r0, c1, r1 = c0[keep], r0[keep], c1[keep], r1[keep]
        length = np.maximum(np.hypot(c1 - c0, r1 - r0), 1.0)
        nsamp = np.minimum(length.astype(int) + 1, 2048)
        color = np.asarray(color, dtype=np.uint8)
        h, w = img.shape[:2]
        for i in range(len(c0)):
            t = np.linspace(0.0, 1.0, nsamp[i])
            cc = (c0[i] + t * (c1[i] - c0[i])).astype(int)
            rr = (r0[i] + t * (r1[i] - r0[i])).astype(int)
            m = (cc >= 0) & (cc < w) & (rr >= 0) & (rr < h)
            img[rr[m], cc[m]] = color
        return img

    # palette by creation process (track overlays)
    TRACK_COLORS = {
        'cherenkov': (64, 160, 255),
        'scintillation': (255, 220, 64),
        'reemission': (64, 255, 128),
        'other': (200, 200, 200),
    }

    def render_event_to_array(self, ev, max_tracks=500):
        """Geometry render with the event's photon tracks overlaid as
        projected polylines (the reference extrudes photon tracks into
        the scene, chroma/camera.py:849-895; here they rasterize onto
        the image plane, which also works headless)."""
        from chroma_jax import event as evmod
        img = self.render_to_array().copy()
        tracks = getattr(ev, 'photon_tracks', None)
        if tracks:
            for tr in tracks[:max_tracks]:
                if tr is None or len(tr) < 2:
                    continue
                flags = int(tr.flags[-1])
                if flags & evmod.CHERENKOV:
                    color = self.TRACK_COLORS['cherenkov']
                elif flags & evmod.SCINTILLATION:
                    color = self.TRACK_COLORS['scintillation']
                elif flags & evmod.BULK_REEMIT:
                    color = self.TRACK_COLORS['reemission']
                else:
                    color = self.TRACK_COLORS['other']
                self.draw_segments(img, tr.pos[:-1], tr.pos[1:], color)
        for v in (ev.vertices or []):
            if getattr(v, 'steps', None) is not None:
                pts = np.column_stack([v.steps.x, v.steps.y, v.steps.z])
                if len(pts) >= 2:
                    self.draw_segments(img, pts[:-1], pts[1:],
                                       (255, 64, 64))
        return img

    _BOX_EDGES = [(0, 1), (0, 2), (0, 4), (1, 3), (1, 5), (2, 3),
                  (2, 6), (3, 7), (4, 5), (4, 6), (5, 7), (6, 7)]

    def render_bvh_to_array(self, layer=1, color=(255, 128, 0),
                            max_nodes=2048):
        """Geometry render with a BVH layer's AABBs as wireframe
        overlay (reference: chroma/camera.py:442)."""
        from chroma_jax.bvh.bvh import unpack_nodes
        img = self.render_to_array().copy()
        bvh = self.geometry.bvh
        sl = bvh.get_layer(min(layer, bvh.layer_count() - 1))
        info = unpack_nodes(sl.nodes[:max_nodes])
        wc = bvh.world_coords
        xlo = np.column_stack([info['xlo'], info['ylo'], info['zlo']])
        xhi = np.column_stack([info['xhi'], info['yhi'], info['zhi']])
        lo = wc.world_origin + xlo.astype(float) * wc.world_scale
        hi = wc.world_origin + xhi.astype(float) * wc.world_scale
        # corner c of box b: pick lo/hi per axis by bit pattern
        bits = np.array([[(c >> k) & 1 for k in range(3)]
                         for c in range(8)], dtype=bool)   # (8,3)
        pts = np.where(bits[None, :, :], hi[:, None, :], lo[:, None, :])
        for e0, e1 in self._BOX_EDGES:
            self.draw_segments(img, pts[:, e0], pts[:, e1], color)
        return img

    def render_anaglyph_to_array(self, eye_sep=None):
        """Red/cyan stereo render (reference: chroma/camera.py:155)."""
        if eye_sep is None:
            eye_sep = 0.01 * self.scale
        offset = normalize(np.cross(
            np.cross(self.axis1, self.axis2), self.axis1)) * eye_sep
        saved = self.viewpoint.copy()
        try:
            self.viewpoint = saved - offset / 2
            self._update_rays()
            left = self.render_to_array()
            self.viewpoint = saved + offset / 2
            self._update_rays()
            right = self.render_to_array()
        finally:
            self.viewpoint = saved
            self._update_rays()
        img = right.copy()
        # luminance of the left eye into the red channel
        lum = (0.299 * left[..., 0] + 0.587 * left[..., 1]
               + 0.114 * left[..., 2]).astype(np.uint8)
        img[..., 0] = lum
        return img

    def render_hybrid_to_array(self, light_position=None, nlookup=2,
                               exposure=None):
        """Progressive photon-map render (reference chroma/camera.py
        hybrid_render toggle + cuda/hybrid_render.cu): a point light at
        ``light_position`` (default: the viewpoint) illuminates the
        scene; camera rays read the resulting per-triangle map."""
        from chroma_jax.ops.hybrid import HybridRenderer
        if getattr(self, '_hybrid', None) is None:
            self._hybrid = HybridRenderer(self.gpu_geometry)
        hyb = self._hybrid
        if light_position is None:
            light_position = self.viewpoint
        for _ in range(max(nlookup - hyb.nlookup_calls, 0)):
            hyb.update_xyz_lookup(light_position)
        img = np.asarray(hyb.render(self.rays.pos, self.rays.dir))
        if exposure is None:
            peak = float(np.percentile(img, 99.5))
            exposure = 1.0 / peak if peak > 0 else 1.0
        pixels = hyb.process_image(img, scale=exposure)
        return pixels_to_rgb_array(pixels, self.size)

    def orbit_movie(self, path_pattern, nframes=36, axis=None):
        """Render an orbit around the target as numbered PNG frames
        (the reference captures movies frame-by-frame from its pygame
        loop, chroma/camera.py:574)."""
        from PIL import Image
        axis = self.axis1 if axis is None else axis
        paths = []
        for i in range(nframes):
            arr = self.render_to_array()
            path = path_pattern % i
            Image.fromarray(arr).save(path)
            paths.append(path)
            self.rotate(2 * np.pi / nframes, axis)
        return paths

    # ---- rendering ---------------------------------------------------

    def render_pixels(self):
        return self.rays.snapshot(self.gpu_geometry,
                                  alpha_depth=self.alpha_depth)

    def render_to_array(self):
        return pixels_to_rgb_array(self.render_pixels(), self.size)

    def render_to_image(self):
        from PIL import Image
        return Image.fromarray(self.render_to_array())

    def snapshot(self, filename):
        self.render_to_image().save(filename)
        logger.info('wrote %s', filename)
        return filename

    # ---- interactive loop --------------------------------------------

    #: mode toggles available in the interactive loop (reference:
    #: chroma/camera.py:574-646 — F5 hybrid, F6 stereo, F7 BVH
    #: wireframe, F11 movie capture)
    HELP = """\
drag rotate | shift-drag pan | wheel / +,- zoom | arrows orbit+dolly
F5 hybrid | F6 anaglyph | F7 bvh wireframe ([,] layer) | F11 movie
s screenshot | ESC/q quit"""

    _mode = 'normal'
    _bvh_layer = None
    _movie = None
    _tracks = False

    def _frame(self):
        """Render one frame honoring the active display mode."""
        if self._mode == 'hybrid':
            arr = self.render_hybrid_to_array()
        elif self._mode == 'anaglyph':
            arr = self.render_anaglyph_to_array()
        else:
            arr = self.render_to_array()
        if self._bvh_layer is not None and self._mode == 'normal':
            arr = self.render_bvh_to_array(layer=self._bvh_layer)
        return arr

    def _handle_key(self, ev, pygame):
        """Shared key handling; returns False to quit."""
        step = 0.1 * self.scale * normalize(
            self.mesh_center - self.viewpoint)
        if ev.key in (pygame.K_ESCAPE, pygame.K_q):
            return False
        elif ev.key == pygame.K_LEFT:
            self.rotate(np.pi / 18, self.axis1)
        elif ev.key == pygame.K_RIGHT:
            self.rotate(-np.pi / 18, self.axis1)
        elif ev.key == pygame.K_UP:
            self.translate(step)
        elif ev.key == pygame.K_DOWN:
            self.translate(-step)
        elif ev.key in (pygame.K_EQUALS, pygame.K_PLUS,
                        pygame.K_KP_PLUS):
            self.translate(0.5 * step)
        elif ev.key in (pygame.K_MINUS, pygame.K_KP_MINUS):
            self.translate(-0.5 * step)
        elif ev.key == pygame.K_F5:        # hybrid render toggle
            self._mode = 'hybrid' if self._mode != 'hybrid' else 'normal'
        elif ev.key == pygame.K_F6:        # anaglyph stereo toggle
            self._mode = ('anaglyph' if self._mode != 'anaglyph'
                          else 'normal')
        elif ev.key == pygame.K_F7:        # BVH wireframe toggle
            self._bvh_layer = 1 if self._bvh_layer is None else None
        elif ev.key == pygame.K_LEFTBRACKET and self._bvh_layer:
            self._bvh_layer = max(self._bvh_layer - 1, 0)
        elif ev.key == pygame.K_RIGHTBRACKET \
                and self._bvh_layer is not None:
            self._bvh_layer += 1
        elif ev.key == pygame.K_F11:       # movie capture toggle
            self._movie = 0 if self._movie is None else None
        elif ev.key == pygame.K_s:
            self.snapshot('camera-%06d.png' % np.random.randint(1e6))
        return True

    def run(self):
        """pygame interactive loop (reference: chroma/camera.py:646):
        mouse-drag rotate, shift-drag pan, wheel zoom, arrow keys,
        F5 hybrid render, F6 anaglyph, F7 BVH wireframe with [,] layer
        select, F11 frame capture, s screenshot."""
        os.environ.setdefault('SDL_VIDEODRIVER',
                              os.environ.get('SDL_VIDEODRIVER', ''))
        import pygame
        pygame.init()
        screen = pygame.display.set_mode(self.size)
        pygame.display.set_caption('chroma-jax camera')
        clock = pygame.time.Clock()
        self._mode = 'normal'
        self._bvh_layer = None
        self._movie = None
        logger.info(self.HELP)

        done = False
        while not done:
            for ev in pygame.event.get():
                if ev.type == pygame.QUIT:
                    done = True
                elif ev.type == pygame.KEYDOWN:
                    if not self._handle_key(ev, pygame):
                        done = True
                elif ev.type == pygame.MOUSEMOTION and ev.buttons[0]:
                    dx, dy = ev.rel
                    mods = pygame.key.get_mods()
                    if mods & pygame.KMOD_SHIFT:   # pan in film plane
                        self.translate((-dx * self.axis2
                                        + dy * self.axis1)
                                       * 0.001 * self.scale)
                    else:
                        self.rotate(-dx * 0.005, self.axis1)
                        self.rotate(-dy * 0.005, self.axis2)
                elif ev.type == pygame.MOUSEWHEEL:
                    self.translate(0.05 * ev.y * self.scale * normalize(
                        self.mesh_center - self.viewpoint))

            arr = self._frame()
            if self._movie is not None:
                from PIL import Image
                Image.fromarray(arr).save('frame-%06d.png' % self._movie)
                self._movie += 1
            surf = pygame.surfarray.make_surface(
                arr.transpose(1, 0, 2)[:, ::-1])
            screen.blit(surf, (0, 0))
            pygame.display.flip()
            clock.tick(30)
        pygame.quit()


class EventViewer(Camera):
    """Camera that steps through simulated events, coloring hit PMTs
    by charge or time (reference: chroma/camera.py:720)."""

    def __init__(self, geometry, events, size=(800, 600), **kwargs):
        Camera.__init__(self, geometry, size=size, **kwargs)
        self.events = list(events)
        self.event_index = 0
        if self.events:
            self.color_by_event(self.events[0])

    def color_by_event(self, ev, mode='charge'):
        """Recolor PMT solids by the event's channel charge/time."""
        if ev.channels is None:
            return
        from matplotlib import cm
        chan = ev.channels
        nsolids = len(self.geometry.solid_id_to_channel_index)
        solid_hit = np.zeros(nsolids, dtype=bool)
        colors = np.zeros(nsolids, dtype=np.uint32)
        values = chan.q if mode == 'charge' else chan.t
        vrange = values[chan.hit]
        if len(vrange) == 0:
            return
        lo, hi = vrange.min(), max(vrange.max(), vrange.min() + 1e-9)
        cmap = cm.get_cmap('jet') if hasattr(cm, 'get_cmap') else \
            __import__('matplotlib').colormaps['jet']
        for ci, sid in enumerate(self.geometry.channel_index_to_solid_id):
            if chan.hit[ci]:
                frac = float((values[ci] - lo) / (hi - lo))
                r, g, b, _ = cmap(frac)
                solid_hit[sid] = True
                colors[sid] = (int(r * 255) << 16) | (int(g * 255) << 8) \
                    | int(b * 255)
        self.gpu_geometry.color_solids(solid_hit, colors)

    #: key bindings on top of Camera.HELP (reference EventViewer
    #: handles PAGEUP/PAGEDOWN event stepping and charge/time coloring
    #: modes, chroma/camera.py:926)
    HELP = Camera.HELP + """
pgdn/k next event | pgup/j prev event | c charge | t time | x tracks"""

    def _frame(self):
        ev = self.events[self.event_index] if self.events else None
        if ev is not None and self._tracks:
            return self.render_event_to_array(ev)
        return Camera._frame(self)

    def _handle_key(self, ev, pygame):
        if ev.key in (pygame.K_PAGEDOWN, pygame.K_k):
            self.next_event()
        elif ev.key in (pygame.K_PAGEUP, pygame.K_j):
            self.prev_event()
        elif ev.key == pygame.K_c:
            self._color_mode = 'charge'
            self.color_by_event(self.events[self.event_index], 'charge')
        elif ev.key == pygame.K_t:
            self._color_mode = 'time'
            self.color_by_event(self.events[self.event_index], 'time')
        elif ev.key == pygame.K_x:
            self._tracks = not self._tracks
        else:
            return Camera._handle_key(self, ev, pygame)
        return True

    def run(self):
        self._color_mode = 'charge'
        self._tracks = False
        Camera.run(self)

    def next_event(self):
        self.event_index = (self.event_index + 1) % len(self.events)
        self.color_by_event(self.events[self.event_index],
                            getattr(self, '_color_mode', 'charge'))

    def prev_event(self):
        self.event_index = (self.event_index - 1) % len(self.events)
        self.color_by_event(self.events[self.event_index],
                            getattr(self, '_color_mode', 'charge'))

    def snapshot_event(self, filename, mode='charge'):
        """PNG of the current event: channels colored + photon tracks /
        particle steps overlaid."""
        from PIL import Image
        ev = self.events[self.event_index]
        self.color_by_event(ev, mode=mode)
        arr = self.render_event_to_array(ev)
        Image.fromarray(arr).save(filename)
        logger.info('wrote %s', filename)
        return filename


def view(obj, size=(800, 600), **kwargs):
    """Convenience: build a camera for any geometry-ish object and run
    interactively if possible, else snapshot (reference:
    chroma/camera.py view)."""
    from chroma_jax.loader import create_geometry_from_obj
    geometry = create_geometry_from_obj(obj)
    cam = Camera(geometry, size=size, **kwargs)
    if os.environ.get('DISPLAY') or os.environ.get(
            'SDL_VIDEODRIVER') not in (None, '', 'dummy'):
        cam.run()
    else:
        cam.snapshot('chroma_camera.png')
    return cam
