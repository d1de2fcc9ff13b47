"""Simulation: the central event-processing driver.

(parity: chroma/sim.py Simulation) — takes a flattened
Geometry/Detector, owns the device tables, batches photon bundles into
megabatches, runs the wavefront propagation + DAQ, and yields Events.
Photon generation from particle vertices runs in a forked worker pool
(ZMQ) exactly like the reference; set ``geant4_processes=0`` to feed
Photons directly.
"""
import os
import time

import numpy as np

from chroma_jax import event
from chroma_jax import generator
from chroma_jax import gpu
from chroma_jax import itertoolset
from chroma_jax.geometry import Geometry
from chroma_jax.log import logger


def pick_seed():
    """Seed from time + PID (reference: chroma/sim.py:16)."""
    return int(time.time()) ^ (os.getpid() << 16) & (2 ** 32 - 1)


class Simulation(object):
    def __init__(self, detector, seed=None, cuda_device=None,
                 particle_tracking=False, photon_tracking=False,
                 geant4_processes=4, nthreads_per_block=64,
                 max_blocks=1024, devices=None, mesh=None):
        """``devices``/``mesh``: propagate each batch sharded over a
        multi-device jax Mesh (photon-axis data parallelism; a
        capability the single-GPU reference does not have).  With
        neither given, a multi-device process auto-builds a mesh over
        all local devices."""
        if isinstance(detector, str):
            from chroma_jax.loader import load_geometry_from_string
            detector = load_geometry_from_string(detector)
        elif getattr(detector, 'bvh', None) is None:
            # accept un-flattened geometries: flatten + cached BVH.  The
            # legacy BVH only feeds the escape-rope walker tables, which
            # pack_geometry leaves out above LEGACY_WALKER_MAX_TRIANGLES,
            # so it is not built for such meshes.
            from chroma_jax.loader import create_geometry_from_obj
            from chroma_jax.ops.geometry_pack import \
                LEGACY_WALKER_MAX_TRIANGLES
            build_bvh = True
            if isinstance(detector, Geometry):
                detector.flatten()
                build_bvh = len(detector.mesh.triangles) \
                    <= LEGACY_WALKER_MAX_TRIANGLES
            detector = create_geometry_from_obj(detector,
                                                auto_build_bvh=build_bvh)
        self.detector = detector
        self.photon_tracking = photon_tracking
        self.seed = pick_seed() if seed is None else seed
        np.random.seed(self.seed)

        if geant4_processes > 0:
            self.photon_generator = generator.G4ParallelGenerator(
                geant4_processes, detector.detector_material,
                base_seed=self.seed, tracking=particle_tracking)
        else:
            self.photon_generator = None

        if hasattr(detector, 'num_channels'):
            self.gpu_geometry = gpu.GPUDetector(detector)
            self.gpu_daq = gpu.GPUDaq(self.gpu_geometry)
            self.gpu_pdf = gpu.GPUPDF()
            self.gpu_pdf_kernel = gpu.GPUKernelPDF()
        else:
            self.gpu_geometry = gpu.GPUGeometry(detector)

        import jax
        if mesh is None and devices is not None:
            from chroma_jax.parallel import make_photon_mesh
            mesh = make_photon_mesh(devices)
        elif mesh is None and len(jax.devices()) > 1:
            from chroma_jax.parallel import make_photon_mesh
            mesh = make_photon_mesh()
        self.mesh = mesh

        self.rng_states = gpu.get_rng_states(seed=self.seed)
        self.pdf_config = None

    # ------------------------------------------------------------------

    def _simulate_batch(self, batch_events, keep_photons_beg=False,
                        keep_photons_end=False, keep_hits=True,
                        keep_flat_hits=True, run_daq=False, max_steps=100,
                        verbose=False):
        batch_photons = event.Photons.join(
            [ev.photons_beg for ev in batch_events])
        batch_bounds = np.cumsum(np.concatenate(
            [[0], [len(ev.photons_beg) for ev in batch_events]]))

        gpu_photons = gpu.GPUPhotons(batch_photons, copy_triangles=False,
                                     copy_weights=False)
        is_detector = hasattr(self.detector, 'num_channels')
        sharded_daq = (run_daq and is_detector and self.mesh is not None
                       and int(self.mesh.devices.size) > 1
                       and not self.photon_tracking)
        batch_channels = None
        if sharded_daq:
            # the multi-device step: propagate + per-event DAQ +
            # channel reductions in ONE sharded program (pmin/psum/OR
            # collectives replace the reference's device atomics,
            # chroma/cuda/daq.cu:73-75), instead of gathering the batch
            # and digitizing single-device
            from chroma_jax import parallel
            from chroma_jax.ops import photon as photon_ops
            n = gpu_photons.state['pos'].shape[0]
            state, _ = parallel.pad_to_multiple(
                gpu_photons.state, int(self.mesh.devices.size))
            out_state, batch_channels = parallel.propagate_and_daq_sharded(
                state, self.gpu_geometry.geom, self.gpu_geometry.det,
                self.rng_states.next(), self.mesh,
                nchannels=self.gpu_geometry.nchannels,
                max_steps=max_steps, nevents=len(batch_events))
            out_state = photon_ops.unsort_photons(out_state)
            gpu_photons.state = {k: v[:n] for k, v in out_state.items()}
            tracking = None
        else:
            tracking = gpu_photons.propagate(
                self.gpu_geometry, self.rng_states, max_steps=max_steps,
                track=self.photon_tracking, mesh=self.mesh)

        aborted = (np.asarray(gpu_photons.state['flags'])
                   & event.NAN_ABORT) != 0
        if aborted.any():
            logger.warning('%d ABORTED PHOTONS', int(aborted.sum()))

        if keep_photons_end:
            batch_photons_end = gpu_photons.get()

        if is_detector and (keep_hits or keep_flat_hits):
            batch_hits = gpu_photons.get_flat_hits(self.gpu_geometry)

        for i, (batch_ev, (start, end)) in enumerate(zip(
                batch_events, zip(batch_bounds[:-1], batch_bounds[1:]))):
            if not keep_photons_beg:
                batch_ev.photons_beg = None
            if self.photon_tracking and tracking is not None:
                step_ids, step_photons = tracking
                nph = end - start
                tracks = [[] for _ in range(nph)]
                for ids, photons in zip(step_ids, step_photons):
                    mask = (ids >= start) & (ids < end)
                    if not mask.any():
                        continue
                    local = ids[mask] - start
                    sub = photons[mask]
                    for j, pid in enumerate(local):
                        tracks[pid].append(sub[j:j + 1])
                batch_ev.photon_tracks = [
                    event.Photons.join(t) if t else event.Photons()
                    for t in tracks]
            if keep_photons_end:
                batch_ev.photons_end = batch_photons_end[start:end]
            if is_detector and (keep_hits or keep_flat_hits):
                ev_hits = batch_hits[batch_hits.evidx == i]
                if keep_hits:
                    batch_ev.hits = {
                        int(c): ev_hits[ev_hits.channel == c]
                        for c in np.unique(ev_hits.channel)}
                if keep_flat_hits:
                    batch_ev.flat_hits = ev_hits
            if is_detector and run_daq:
                if batch_channels is not None:
                    # per-event block of the sharded megabatch DAQ
                    nch = self.gpu_geometry.nchannels
                    sl = slice(i * nch, (i + 1) * nch)
                    batch_ev.channels = gpu.GPUChannels(
                        batch_channels['t'][sl], batch_channels['q'][sl],
                        batch_channels['flags'][sl]).get()
                else:
                    # DAQ must run per event (channels are per-event)
                    sub = gpu.GPUPhotons.__new__(gpu.GPUPhotons)
                    sub.state = {k: v[start:end]
                                 for k, v in gpu_photons.state.items()}
                    sub.true_nphotons = end - start
                    sub.stride = end - start
                    sub.ncopies = 1
                    self.gpu_daq.begin_acquire()
                    self.gpu_daq.acquire(sub, self.rng_states)
                    batch_ev.channels = self.gpu_daq.end_acquire().get()
            yield batch_ev

    def simulate(self, iterable, keep_photons_beg=False,
                 keep_photons_end=False, keep_hits=True,
                 keep_flat_hits=True, run_daq=False, max_steps=100,
                 photons_per_batch=1000000, evid_start=0):
        """Yield simulated Events for an iterable of Photons / Vertex /
        Event objects (reference: chroma/sim.py:141)."""
        if isinstance(iterable, event.Photons):
            first_element, iterable = iterable, [iterable]
        else:
            first_element, iterable = itertoolset.peek(iterable)

        if isinstance(first_element, event.Event):
            if self.photon_generator is not None:
                iterable = self.photon_generator.generate_events(iterable)
            elif first_element.photons_beg is None:
                raise RuntimeError('events carry no photons and the '
                                   'simulation was created with '
                                   'geant4_processes=0')
        elif isinstance(first_element, event.Photons):
            iterable = (event.Event(photons_beg=x) for x in iterable)
        elif isinstance(first_element, event.Vertex):
            iterable = (event.Event(vertices=[v]) for v in iterable)
            iterable = self.photon_generator.generate_events(iterable)

        nphotons = 0
        batch_events = []
        evid = evid_start
        for ev in iterable:
            ev.id = evid
            evid += 1
            ev.nphotons = len(ev.photons_beg)
            ev.photons_beg.evidx[:] = len(batch_events)
            nphotons += ev.nphotons
            batch_events.append(ev)
            if nphotons >= photons_per_batch:
                yield from self._simulate_batch(
                    batch_events, keep_photons_beg=keep_photons_beg,
                    keep_photons_end=keep_photons_end, keep_hits=keep_hits,
                    keep_flat_hits=keep_flat_hits, run_daq=run_daq,
                    max_steps=max_steps)
                nphotons = 0
                batch_events = []
        if batch_events:
            yield from self._simulate_batch(
                batch_events, keep_photons_beg=keep_photons_beg,
                keep_photons_end=keep_photons_end, keep_hits=keep_hits,
                keep_flat_hits=keep_flat_hits, run_daq=run_daq,
                max_steps=max_steps)

    # ------------------------------------------------------------------

    def _ensure_photon_events(self, first_element, iterable):
        """Route an iterable of Photons / Vertex / Event into an
        iterable of Events with photons_beg filled."""
        if isinstance(first_element, event.Photons):
            return (event.Event(photons_beg=x) for x in iterable)
        if isinstance(first_element, event.Vertex):
            iterable = (event.Event(vertices=[v]) for v in iterable)
            return self.photon_generator.generate_events(iterable)
        if isinstance(first_element, event.Event):
            if first_element.photons_beg is not None:
                return iterable
            return self.photon_generator.generate_events(iterable)
        raise TypeError('cannot simulate %r' % type(first_element))

    def create_pdf(self, iterable, tbins, trange, qbins, qrange, nreps=1):
        """(hitcounts, 3D (channel,t,q) pdf histogram) from simulating
        the given events (reference: chroma/sim.py:188)."""
        if isinstance(iterable, event.Photons):
            first_element, iterable = iterable, [iterable]
        else:
            first_element, iterable = itertoolset.peek(iterable)
        iterable = self._ensure_photon_events(first_element, iterable)

        pdf_config = (tbins, trange, qbins, qrange)
        if pdf_config != self.pdf_config:
            self.pdf_config = pdf_config
            self.gpu_pdf.setup_pdf(self.detector.num_channels(), tbins,
                                   trange, qbins, qrange)
        else:
            self.gpu_pdf.clear_pdf()

        if nreps > 1:
            iterable = itertoolset.repeating_iterator(iterable, nreps)

        for ev in iterable:
            gpu_photons = gpu.GPUPhotons(ev.photons_beg)
            gpu_photons.propagate(self.gpu_geometry, self.rng_states,
                                  mesh=self.mesh)
            self.gpu_daq.begin_acquire()
            self.gpu_daq.acquire(gpu_photons, self.rng_states)
            gpu_channels = self.gpu_daq.end_acquire()
            self.gpu_pdf.add_hits_to_pdf(gpu_channels)
        return self.gpu_pdf.get_pdfs()

    def eval_pdf(self, event_channels, iterable, min_twidth, trange,
                 min_qwidth, qrange, min_bin_content=100, nreps=1, ndaq=1,
                 nscatter=1, time_only=True):
        """Variable-bin PDF evaluation with importance-weighted
        scatter/no-scatter splits (reference: chroma/sim.py:219)."""
        ndaq_per_rep = min(64, ndaq)
        ndaq_reps = max(ndaq // ndaq_per_rep, 1)
        gpu_daq = gpu.GPUDaq(self.gpu_geometry, ndaq=ndaq_per_rep)

        self.gpu_pdf.setup_pdf_eval(event_channels.hit, event_channels.t,
                                    event_channels.q, min_twidth, trange,
                                    min_qwidth, qrange,
                                    min_bin_content=min_bin_content,
                                    time_only=time_only)

        # a bare Photons bundle is ONE event, same convenience as
        # simulate() — iterating it directly would split it into
        # single-photon events (Photons.__getitem__)
        if isinstance(iterable, event.Photons):
            first_element, iterable = iterable, [iterable]
        else:
            first_element, iterable = itertoolset.peek(iterable)
        iterable = self._ensure_photon_events(first_element, iterable)

        for ev in iterable:
            no_scatter = gpu.GPUPhotons(ev.photons_beg, ncopies=nreps)
            scatter = gpu.GPUPhotons(ev.photons_beg,
                                     ncopies=nreps * nscatter)
            no_scatter.propagate(self.gpu_geometry, self.rng_states,
                                 mesh=self.mesh,
                                 use_weights=True, scatter_first=-1,
                                 max_steps=10)
            scatter.propagate(self.gpu_geometry, self.rng_states,
                              mesh=self.mesh,
                              use_weights=True, scatter_first=1,
                              max_steps=5)
            stride = no_scatter.stride
            for i in range(no_scatter.ncopies):
                ns_slice = no_scatter.select(event.SURFACE_DETECT,
                                             start_photon=i * stride,
                                             nphotons=stride)
                sc_slices = [scatter.select(
                    event.SURFACE_DETECT,
                    start_photon=(nscatter * i + j) * scatter.stride,
                    nphotons=scatter.stride) for j in range(nscatter)]
                if ns_slice.true_nphotons == 0:
                    continue
                for _ in range(ndaq_reps):
                    gpu_daq.begin_acquire()
                    gpu_daq.acquire(ns_slice, self.rng_states)
                    for sc in sc_slices:
                        if sc.true_nphotons:
                            gpu_daq.acquire(sc, self.rng_states,
                                            weight=1.0 / nscatter)
                    gpu_channels = gpu_daq.end_acquire()
                    self.gpu_pdf.accumulate_pdf_eval(gpu_channels)
        return self.gpu_pdf.get_pdf_eval()

    def setup_kernel(self, event_channels, bandwidth_iterable, trange,
                     qrange, nreps=1, ndaq=1, time_only=True,
                     scale_factor=1.0):
        """Accumulate moments + compute KDE bandwidths
        (reference: chroma/sim.py:285)."""
        nchannels = len(event_channels.hit)
        self.gpu_pdf_kernel.setup_moments(nchannels, trange, qrange,
                                          time_only=time_only)
        first_element, bandwidth_iterable = \
            itertoolset.peek(bandwidth_iterable)
        bandwidth_iterable = self._ensure_photon_events(
            first_element, bandwidth_iterable)
        for ev in bandwidth_iterable:
            gpu_photons = gpu.GPUPhotons(ev.photons_beg, ncopies=nreps)
            gpu_photons.propagate(self.gpu_geometry, self.rng_states,
                                  mesh=self.mesh)
            for ph_slice in gpu_photons.iterate_copies():
                for _ in range(ndaq):
                    self.gpu_daq.begin_acquire()
                    self.gpu_daq.acquire(ph_slice, self.rng_states)
                    gpu_channels = self.gpu_daq.end_acquire()
                    self.gpu_pdf_kernel.accumulate_moments(gpu_channels)
        self.gpu_pdf_kernel.compute_bandwidth(event_channels.hit,
                                              event_channels.t,
                                              event_channels.q,
                                              scale_factor=scale_factor)

    def eval_kernel(self, event_channels, kernel_iterable, trange, qrange,
                    nreps=1, ndaq=1, naverage=1, time_only=True):
        """(hitcount, KDE pdf values) (reference: chroma/sim.py:315)."""
        self.gpu_pdf_kernel.setup_kernel(event_channels.hit,
                                         event_channels.t,
                                         event_channels.q)
        first_element, kernel_iterable = itertoolset.peek(kernel_iterable)
        kernel_iterable = self._ensure_photon_events(first_element,
                                                     kernel_iterable)
        for ev in kernel_iterable:
            gpu_photons = gpu.GPUPhotons(ev.photons_beg, ncopies=nreps)
            gpu_photons.propagate(self.gpu_geometry, self.rng_states,
                                  mesh=self.mesh)
            for ph_slice in gpu_photons.iterate_copies():
                for _ in range(ndaq):
                    self.gpu_daq.begin_acquire()
                    self.gpu_daq.acquire(ph_slice, self.rng_states)
                    gpu_channels = self.gpu_daq.end_acquire()
                    self.gpu_pdf_kernel.accumulate_kernel(gpu_channels)
        return self.gpu_pdf_kernel.get_kernel_eval()
