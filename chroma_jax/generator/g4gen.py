"""Geant4-backed photon generation (parity: chroma/generator/g4gen.py).

The reference builds a Geant4 world of the detector material, converts
chroma Materials into G4 materials with scintillation property tables,
fires the particle gun, and harvests optical photons from a tracking
action that kills them at creation (reference: chroma/generator/
g4gen.py:64-163 + src/G4chroma.cc:184-206).  This module implements
the same behavior on top of ``geant4_pybind``: a one-material world,
Penelope EM + optical physics, and a stacking action that records and
kills every optical photon at creation so Geant4 never transports
them (the JAX engine does).

Importing this module raises ImportError when no Geant4 python
bindings are installed; the worker pool then falls back to the native
physics-grade ``TrackGenerator`` (chroma_jax/generator/trackgen.py).
"""
import os

import numpy as np

import geant4_pybind as g4

from chroma_jax import event

HBARC_MEV_NM = 197.3269804e-6   # MeV * nm
MM = 1.0                        # Geant4 default length unit is mm


class g4mute(object):
    """Silence Geant4 console output for the duration of a with-block
    (reference: src/mute.cc:17-25 swaps G4cout/G4cerr streambufs; from
    Python we redirect the process stdout/stderr file descriptors,
    which also catches output written by C++ directly)."""

    def __enter__(self):
        self._fds = (os.dup(1), os.dup(2))
        self._null = os.open(os.devnull, os.O_WRONLY)
        os.dup2(self._null, 1)
        os.dup2(self._null, 2)
        return self

    def __exit__(self, *exc):
        os.dup2(self._fds[0], 1)
        os.dup2(self._fds[1], 2)
        os.close(self._fds[0])
        os.close(self._fds[1])
        os.close(self._null)
        return False


class _nullcontext(object):
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


def _to_energy_pairs(data):
    """(wavelength nm, value) table -> (energies MeV ascending, values)
    as the reference's add_prop does (g4gen.py:22)."""
    data = np.asarray(data, float)
    e = 2 * np.pi * HBARC_MEV_NM / data[::-1, 0]
    return e.tolist(), data[::-1, 1].tolist()


def create_g4material(material):
    """chroma Material -> G4Material with optical/scintillation tables
    (reference: chroma/generator/g4gen.py:37-61)."""
    nist = g4.G4NistManager.Instance()
    comp = getattr(material, 'composition', None) or \
        {'H': 0.1119, 'O': 0.8881}
    density = (getattr(material, 'density', 0.0) or 1.0) * g4.g / g4.cm3
    g4mat = g4.G4Material(material.name, density, len(comp))
    for symbol, frac in comp.items():
        g4mat.AddElement(nist.FindOrBuildElement(symbol), float(frac))

    table = g4.G4MaterialPropertiesTable()
    if getattr(material, 'refractive_index', None) is not None:
        e, v = _to_energy_pairs(material.refractive_index)
        table.AddProperty('RINDEX', e, v)
    spec = getattr(material, 'scintillation_spectrum', None)
    if spec is not None:
        spec = np.asarray(spec, float)
        # dy/dwavelength -> dy/denergy, as the reference's
        # 'dy_dwavelength' option does (g4gen.py:24)
        e, v = _to_energy_pairs(np.column_stack(
            [spec[:, 0],
             spec[:, 1] * spec[:, 0] ** 2 / (2 * np.pi * HBARC_MEV_NM)]))
        table.AddProperty('SCINTILLATIONCOMPONENT1', e, v)
        table.AddConstProperty('SCINTILLATIONYIELD1', 1.0)
    ly = getattr(material, 'scintillation_light_yield', None)
    if ly:
        table.AddConstProperty('SCINTILLATIONYIELD', float(ly) / g4.MeV)
        table.AddConstProperty('RESOLUTIONSCALE', 1.0)
    wf = getattr(material, 'scintillation_waveform', None)
    if wf is not None:
        wf = np.asarray(wf, float)
        if np.all(wf[:, 0] <= 0):          # (-tau, amplitude) rows
            table.AddConstProperty('SCINTILLATIONTIMECONSTANT1',
                                   float(-wf[0, 0]) * g4.ns)
    rise = getattr(material, 'scintillation_rise_time', None)
    if rise:
        table.AddConstProperty('SCINTILLATIONRISETIME1',
                               float(rise) * g4.ns)
    g4mat.SetMaterialPropertiesTable(table)

    mod = getattr(material, 'scintillation_mod', None)
    if mod is not None:
        from chroma_jax.generator.trackgen import _birks_constant_mm
        g4mat.GetIonisation().SetBirksConstant(
            _birks_constant_mm(material) * g4.mm / g4.MeV)
    return g4mat


class _World(g4.G4VUserDetectorConstruction):
    def __init__(self, g4material, size_m=100.0):
        super().__init__()
        self.material = g4material
        self.size = size_m * g4.m

    def Construct(self):
        box = g4.G4Box('world', self.size / 2, self.size / 2,
                       self.size / 2)
        lv = g4.G4LogicalVolume(box, self.material, 'world')
        return g4.G4PVPlacement(None, g4.G4ThreeVector(), lv, 'world',
                                None, False, 0)


class _Physics(g4.G4VModularPhysicsList):
    """Penelope low-energy EM + optical processes WITHOUT the stock G4
    scintillation — scintillation is driven per step by the stepping
    action through the GLG4Scint-equivalent ``ScintillationModel``
    (reference: src/G4chroma.cc:17-34 registers the same list with
    kScintillation disabled and GLG4Scint handling it instead)."""

    def __init__(self):
        super().__init__()
        self.RegisterPhysics(g4.G4EmPenelopePhysics(0))
        optical = g4.G4OpticalPhysics()
        try:                      # Geant4 >= 10.7 singleton switchboard
            g4.G4OpticalParameters.Instance().SetProcessActivation(
                'Scintillation', False)
        except AttributeError:    # older bindings: configure on the list
            optical.Configure(g4.G4OpticalProcessIndex.kScintillation,
                              False)
        self.RegisterPhysics(optical)


class _PhotonHarvester(g4.G4UserStackingAction):
    """Records optical photons at creation and kills them — the
    pybind equivalent of the reference TrackingAction
    (src/G4chroma.cc:184-206)."""

    def __init__(self):
        super().__init__()
        self.reset()

    def reset(self):
        self.pos, self.dir, self.pol = [], [], []
        self.wavelength, self.t, self.flags = [], [], []
        self.parent_ids = []

    def extend(self, photons, parent_id):
        """Append an event.Photons bundle produced outside Geant4
        (the stepping action's scintillation)."""
        self.pos.extend(photons.pos.tolist())
        self.dir.extend(photons.dir.tolist())
        self.pol.extend(photons.pol.tolist())
        self.wavelength.extend(photons.wavelengths.tolist())
        self.t.extend(photons.t.tolist())
        self.flags.extend(photons.flags.tolist())
        self.parent_ids.extend([parent_id] * len(photons))

    def ClassifyNewTrack(self, track):
        if track.GetDefinition() == \
                g4.G4OpticalPhoton.OpticalPhotonDefinition():
            p = track.GetPosition()
            d = track.GetMomentumDirection()
            q = track.GetPolarization()
            self.pos.append((p.x, p.y, p.z))
            self.dir.append((d.x, d.y, d.z))
            self.pol.append((q.x, q.y, q.z))
            self.wavelength.append(
                2 * np.pi * HBARC_MEV_NM / track.GetKineticEnergy())
            self.t.append(track.GetGlobalTime() / g4.ns)
            proc = track.GetCreatorProcess()
            name = proc.GetProcessName() if proc else ''
            flag = event.CHERENKOV if 'Cerenkov' in name else (
                event.SCINTILLATION if 'Scint' in name else 0)
            self.flags.append(flag)
            self.parent_ids.append(track.GetParentID())
            return g4.G4ClassificationOfNewTrack.fKill
        return g4.G4ClassificationOfNewTrack.fUrgent

    def photons(self):
        n = len(self.pos)
        if n == 0:
            return event.Photons()
        return event.Photons(
            pos=np.asarray(self.pos, np.float32),
            dir=np.asarray(self.dir, np.float32),
            pol=np.asarray(self.pol, np.float32),
            wavelengths=np.asarray(self.wavelength, np.float32),
            t=np.asarray(self.t, np.float32),
            flags=np.asarray(self.flags, np.uint32))

    def parent_track_ids(self):
        return np.asarray(self.parent_ids, np.int32)


class _TrackRecord(object):
    """One particle track's recorded step points (reference:
    src/G4chroma.cc Track / appendStepPoint)."""

    __slots__ = ('id', 'parent_id', 'pdg_code', 'name', 'weight',
                 'steps', 'children')

    def __init__(self, trackid, g4track):
        self.id = trackid
        self.parent_id = g4track.GetParentID()
        self.pdg_code = g4track.GetDefinition().GetPDGEncoding()
        self.name = g4track.GetDefinition().GetParticleName()
        self.weight = g4track.GetWeight()
        self.steps = []          # rows (x,y,z,t,dx,dy,dz,ke,edep,qedep)
        self.children = []

    def append_point(self, point, edep, qedep):
        p = point.GetPosition()
        d = point.GetMomentumDirection()
        self.steps.append(
            (p.x / MM, p.y / MM, p.z / MM,
             point.GetGlobalTime() / g4.ns,
             d.x, d.y, d.z,
             point.GetKineticEnergy() / g4.MeV,
             edep, qedep))

    def as_steps(self):
        a = np.asarray(self.steps, float)
        return event.Steps(a[:, 0], a[:, 1], a[:, 2], a[:, 3],
                           a[:, 4], a[:, 5], a[:, 6], a[:, 7],
                           a[:, 8], a[:, 9])


class _SteppingAction(g4.G4UserSteppingAction):
    """Per-step scintillation + particle-track recording (reference:
    src/G4chroma.cc:46-127 SteppingAction::UserSteppingAction, which
    drives GLG4Scint per step and fills a trackid->Track map).

    Scintillation runs through the native GLG4Scint-equivalent
    ``ScintillationModel`` (trackgen.scintillate_step): Birks-quenched
    dE/dx, Poisson yield, spectrum/waveform sampling.  The generated
    photons are appended straight to the photon harvester instead of
    being created as (immediately killed) Geant4 secondaries — same
    observable result, no G4 track churn."""

    def __init__(self, harvester, rng):
        super().__init__()
        self.harvester = harvester
        self.rng = rng
        self.scint_model = None   # set by G4Generator
        self.scint = True
        self.tracking = False
        self.trackmap = {}

    def clear_tracking(self):
        self.trackmap = {}

    def UserSteppingAction(self, step):
        g4track = step.GetTrack()
        if g4track.GetDefinition() == \
                g4.G4OpticalPhoton.OpticalPhotonDefinition():
            return
        edep = step.GetTotalEnergyDeposit() / g4.MeV
        qedep = edep
        pre = step.GetPreStepPoint()
        post = step.GetPostStepPoint()
        if self.scint and self.scint_model is not None and edep > 0.0:
            p0, p1 = pre.GetPosition(), post.GetPosition()
            from chroma_jax.generator.trackgen import scintillate_step
            qedep, photons = scintillate_step(
                self.scint_model, self.rng,
                (p0.x / MM, p0.y / MM, p0.z / MM),
                (p1.x / MM, p1.y / MM, p1.z / MM),
                pre.GetGlobalTime() / g4.ns,
                post.GetGlobalTime() / g4.ns, edep)
            if photons is not None:
                self.harvester.extend(photons, g4track.GetTrackID())
        if self.tracking:
            trackid = g4track.GetTrackID()
            rec = self.trackmap.get(trackid)
            if rec is None:
                rec = _TrackRecord(trackid, g4track)
                self.trackmap[trackid] = rec
                rec.append_point(pre, 0.0, 0.0)
            rec.append_point(post, edep, qedep)

    def vertex_tree(self, root_id=1):
        """Rebuild the Vertex tree with Steps from the track map
        (reference: chroma/generator/g4gen.py:152
        _extract_vertex_from_stepping_action)."""
        children_of = {}
        for tid, rec in self.trackmap.items():
            children_of.setdefault(rec.parent_id, []).append(tid)

        def build(tid):
            rec = self.trackmap[tid]
            steps = rec.as_steps()
            kids = [build(c) for c in sorted(children_of.get(tid, []))]
            return event.Vertex(
                rec.name,
                np.array([steps.x[0], steps.y[0], steps.z[0]]),
                np.array([steps.dx[0], steps.dy[0], steps.dz[0]]),
                steps.ke[0], t0=steps.t[0], steps=steps,
                children=kids, trackid=tid, pdgcode=rec.pdg_code)

        if root_id not in self.trackmap:
            return None
        return build(root_id)


class _Gun(g4.G4VUserPrimaryGeneratorAction):
    def __init__(self):
        super().__init__()
        self.gun = g4.G4ParticleGun(1)
        self.vertex = None

    def GeneratePrimaries(self, anEvent):
        v = self.vertex
        pd = g4.G4ParticleTable.GetParticleTable().FindParticle(
            v.particle_name)
        self.gun.SetParticleDefinition(pd)
        self.gun.SetParticlePosition(
            g4.G4ThreeVector(*[float(x) * MM for x in v.pos]))
        self.gun.SetParticleMomentumDirection(
            g4.G4ThreeVector(*[float(x) for x in v.dir]))
        self.gun.SetParticleEnergy(float(v.ke) * g4.MeV)
        self.gun.SetParticleTime(float(v.t0) * g4.ns)
        if v.pol is not None:
            self.gun.SetParticlePolarization(
                g4.G4ThreeVector(*[float(x) for x in v.pol]))
        self.gun.GeneratePrimaryVertex(anEvent)


class G4Generator(object):
    """In-process Geant4 photon generator (reference:
    chroma/generator/g4gen.py:64)."""

    supports_tracking = True

    def __init__(self, material, seed=None):
        from chroma_jax.generator.trackgen import ScintillationModel
        if seed is not None:
            g4.G4Random.setTheSeed(int(seed) & 0x7FFFFFFF)
        self.rng = np.random.RandomState(seed)
        self.run_manager = g4.G4RunManagerFactory.CreateRunManager(
            g4.G4RunManagerType.Serial)
        self.world_material = create_g4material(material)
        self.run_manager.SetUserInitialization(_World(self.world_material))
        self.run_manager.SetUserInitialization(_Physics())
        self.harvester = _PhotonHarvester()
        self.stepping = _SteppingAction(self.harvester, self.rng)
        self.stepping.scint_model = ScintillationModel(material)
        self.gun = _Gun()

        class _Init(g4.G4VUserActionInitialization):
            def __init__(s):
                super().__init__()

            def Build(s):
                s.SetUserAction(self.gun)
                s.SetUserAction(self.harvester)
                s.SetUserAction(self.stepping)

        self._init = _Init()
        self.run_manager.SetUserInitialization(self._init)
        with g4mute():
            self.run_manager.Initialize()
            # warm up the physics tables
            self.generate_photons(
                [event.Vertex('e-', (0, 0, 0), (1, 0, 0), 0.5)],
                mute=True)

    def generate_photons(self, vertices, mute=False, tracking=False):
        """Propagate ``vertices`` through Geant4; returns Photons, or
        with ``tracking=True`` the triple ``(tracked_vertices, photons,
        photon_parent_trackids)`` as the reference does
        (chroma/generator/g4gen.py:164 generate_photons)."""
        self.stepping.tracking = tracking
        parts, parent_ids, tracked = [], [], []
        ctx = g4mute() if mute else _nullcontext()
        with ctx:
            for v in vertices:
                self.harvester.reset()
                self.stepping.clear_tracking()
                self.gun.vertex = v
                self.run_manager.BeamOn(1)
                parts.append(self.harvester.photons())
                parent_ids.append(self.harvester.parent_track_ids())
                if tracking:
                    tracked.append(self.stepping.vertex_tree() or v)
                for child in (v.children or []):
                    sub = self.generate_photons([child], mute=False,
                                                tracking=tracking)
                    if tracking:
                        tv, ph, pid = sub
                        tracked.extend(tv)
                        parts.append(ph)
                        parent_ids.append(pid)
                    else:
                        parts.append(sub)
        parts = [p for p in parts if len(p)]
        photons = (event.Photons.join(parts) if parts
                   else event.Photons())
        if tracking:
            parent_ids = [p for p in parent_ids if len(p)]
            parent_ids = (np.concatenate(parent_ids) if parent_ids
                          else np.zeros(0, np.int32))
            return tracked, photons, parent_ids
        return photons
