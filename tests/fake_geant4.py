"""A minimal fake of the ``geant4_pybind`` API surface that
chroma_jax/generator/g4gen.py consumes — just enough to drive one
scripted event through the REAL harvester / stepping / gun wiring.

Install with ``sys.modules['geant4_pybind'] = make_fake()`` BEFORE
importing g4gen.  The fake run manager's BeamOn plays the same
scripted "physics" every time: a primary electron taking two steps
with energy deposit (exercising the per-step scintillation hook and
the track recorder), then one Cherenkov optical photon offered to the
stacking action (which must record and kill it).
"""
import sys
import types

import numpy as np


class _ThreeVector(object):
    def __init__(self, x=0.0, y=0.0, z=0.0):
        self.x, self.y, self.z = float(x), float(y), float(z)


class _ParticleDef(object):
    def __init__(self, name, pdg):
        self._name, self._pdg = name, pdg

    def GetParticleName(self):
        return self._name

    def GetPDGEncoding(self):
        return self._pdg


_OPTICAL = _ParticleDef('opticalphoton', -22)
_PARTICLES = {'e-': _ParticleDef('e-', 11),
              'mu-': _ParticleDef('mu-', 13),
              'opticalphoton': _OPTICAL}


class _Point(object):
    def __init__(self, pos, direction, t, ke):
        self._pos = _ThreeVector(*pos)
        self._dir = _ThreeVector(*direction)
        self._t, self._ke = float(t), float(ke)

    def GetPosition(self):
        return self._pos

    def GetMomentumDirection(self):
        return self._dir

    def GetGlobalTime(self):
        return self._t

    def GetKineticEnergy(self):
        return self._ke


class _Track(object):
    def __init__(self, defn, trackid, parentid, point=None,
                 polarization=(1.0, 0.0, 0.0), creator=None):
        self._defn = defn
        self._id, self._parent = trackid, parentid
        self._point = point
        self._pol = _ThreeVector(*polarization)
        self._creator = creator

    def GetDefinition(self):
        return self._defn

    def GetTrackID(self):
        return self._id

    def GetParentID(self):
        return self._parent

    def GetWeight(self):
        return 1.0

    def GetPosition(self):
        return self._point.GetPosition()

    def GetMomentumDirection(self):
        return self._point.GetMomentumDirection()

    def GetPolarization(self):
        return self._pol

    def GetKineticEnergy(self):
        return self._point.GetKineticEnergy()

    def GetGlobalTime(self):
        return self._point.GetGlobalTime()

    def GetCreatorProcess(self):
        return self._creator


class _Process(object):
    def __init__(self, name):
        self._name = name

    def GetProcessName(self):
        return self._name


class _Step(object):
    def __init__(self, track, edep, pre, post):
        self._track, self._edep = track, edep
        self._pre, self._post = pre, post

    def GetTrack(self):
        return self._track

    def GetTotalEnergyDeposit(self):
        return self._edep

    def GetPreStepPoint(self):
        return self._pre

    def GetPostStepPoint(self):
        return self._post


def make_fake():
    g4 = types.ModuleType('geant4_pybind')

    # ---- units (identity: g4gen works in MeV / mm / ns already) ----
    g4.g = 1.0
    g4.cm3 = 1.0
    g4.m = 1.0
    g4.mm = 1.0
    g4.MeV = 1.0
    g4.ns = 1.0

    # ---- inert geometry / material surface -------------------------
    class _Element(object):
        def __init__(self, symbol):
            self.symbol = symbol

    class _Nist(object):
        _inst = None

        @classmethod
        def Instance(cls):
            if cls._inst is None:
                cls._inst = cls()
            return cls._inst

        def FindOrBuildElement(self, symbol):
            return _Element(symbol)

    class _Ionisation(object):
        def __init__(self):
            self.birks = None

        def SetBirksConstant(self, v):
            self.birks = v

    class _Material(object):
        def __init__(self, name, density, ncomp):
            self.name, self.density = name, density
            self.elements, self.table = [], None
            self._ion = _Ionisation()

        def AddElement(self, elem, frac):
            self.elements.append((elem.symbol, frac))

        def SetMaterialPropertiesTable(self, table):
            self.table = table

        def GetIonisation(self):
            return self._ion

    class _PropTable(object):
        def __init__(self):
            self.props, self.consts = {}, {}

        def AddProperty(self, key, e, v):
            self.props[key] = (list(e), list(v))

        def AddConstProperty(self, key, v):
            self.consts[key] = v

    g4.G4NistManager = _Nist
    g4.G4Material = _Material
    g4.G4MaterialPropertiesTable = _PropTable
    g4.G4Box = lambda *a: None
    g4.G4LogicalVolume = lambda *a: None
    g4.G4PVPlacement = lambda *a, **k: None
    g4.G4ThreeVector = _ThreeVector

    # ---- physics-list surface ---------------------------------------
    class _OpticalParams(object):
        _inst = None
        activations = {}

        @classmethod
        def Instance(cls):
            if cls._inst is None:
                cls._inst = cls()
            return cls._inst

        def SetProcessActivation(self, name, on):
            _OpticalParams.activations[name] = on

    g4.G4EmPenelopePhysics = lambda verbose=0: ('empenelope', verbose)
    g4.G4OpticalPhysics = lambda: 'optical'
    g4.G4OpticalParameters = _OpticalParams

    class _OpticalPhoton(object):
        @staticmethod
        def OpticalPhotonDefinition():
            return _OPTICAL

    g4.G4OpticalPhoton = _OpticalPhoton

    class _Classification(object):
        fKill = 'kill'
        fUrgent = 'urgent'

    g4.G4ClassificationOfNewTrack = _Classification

    class _Random(object):
        seed = None

        @staticmethod
        def setTheSeed(v):
            _Random.seed = v

    g4.G4Random = _Random

    class _PTable(object):
        _inst = None

        @classmethod
        def GetParticleTable(cls):
            if cls._inst is None:
                cls._inst = cls()
            return cls._inst

        def FindParticle(self, name):
            return _PARTICLES[name]

    g4.G4ParticleTable = _PTable

    # ---- user-action base classes (must be DISTINCT classes: the run
    # manager dispatches registered actions by isinstance) ------------
    class _DetectorConstruction(object):
        def __init__(self):
            pass

    class _StackingAction(object):
        def __init__(self):
            pass

    class _SteppingAction(object):
        def __init__(self):
            pass

    class _PrimaryGeneratorAction(object):
        def __init__(self):
            pass

    class _ActionInit(object):
        def __init__(self):
            self._actions = []

        def SetUserAction(self, action):
            self._actions.append(action)

    g4.G4VUserDetectorConstruction = _DetectorConstruction
    g4.G4VModularPhysicsList = type(
        'G4VModularPhysicsList', (object,),
        {'__init__': lambda self: None,
         'RegisterPhysics': lambda self, p: None})
    g4.G4UserStackingAction = _StackingAction
    g4.G4UserSteppingAction = _SteppingAction
    g4.G4VUserPrimaryGeneratorAction = _PrimaryGeneratorAction
    g4.G4VUserActionInitialization = _ActionInit

    # ---- particle gun: records the primary for the run manager ------
    class _Gun(object):
        def __init__(self, n=1):
            self._v = {}

        def SetParticleDefinition(self, pd):
            self._v['particle'] = pd.GetParticleName()

        def SetParticlePosition(self, v):
            self._v['pos'] = (v.x, v.y, v.z)

        def SetParticleMomentumDirection(self, v):
            self._v['dir'] = (v.x, v.y, v.z)

        def SetParticleEnergy(self, e):
            self._v['energy'] = e

        def SetParticleTime(self, t):
            self._v['time'] = t

        def SetParticlePolarization(self, v):
            self._v['pol'] = (v.x, v.y, v.z)

        def GeneratePrimaryVertex(self, evt):
            evt.primary = dict(self._v)

    g4.G4ParticleGun = _Gun

    # ---- run manager: plays the scripted event -----------------------
    class _Event(object):
        primary = None

    class _RunManager(object):
        def __init__(self):
            self.gun = self.stacking = self.stepping = None
            self._inits = []

        def SetUserInitialization(self, obj):
            self._inits.append(obj)

        def Initialize(self):
            for obj in self._inits:
                if isinstance(obj, _ActionInit):
                    obj.Build()
                    for a in obj._actions:
                        if isinstance(a, g4.G4UserStackingAction):
                            self.stacking = a
                        elif isinstance(a, g4.G4UserSteppingAction):
                            self.stepping = a
                        elif isinstance(
                                a, g4.G4VUserPrimaryGeneratorAction):
                            self.gun = a

        def BeamOn(self, n):
            for _ in range(int(n)):
                evt = _Event()
                self.gun.GeneratePrimaries(evt)
                prim = evt.primary
                pos0 = np.asarray(prim['pos'], float)
                pdir = np.asarray(prim['dir'], float)
                ke = prim['energy']
                t0 = prim['time']
                defn = _PTable.GetParticleTable().FindParticle(
                    prim['particle'])
                trk = _Track(defn, trackid=1, parentid=0)
                # two steps: 5 mm and 3 mm, depositing 40% + 60% of ke
                p0 = _Point(pos0, pdir, t0, ke)
                p1 = _Point(pos0 + 5.0 * pdir, pdir, t0 + 0.02,
                            0.6 * ke)
                p2 = _Point(pos0 + 8.0 * pdir, pdir, t0 + 0.05, 0.0)
                self.stepping.UserSteppingAction(
                    _Step(trk, 0.4 * ke, p0, p1))
                self.stepping.UserSteppingAction(
                    _Step(trk, 0.6 * ke, p1, p2))
                # one Cherenkov optical photon of 2.5 eV off step 1
                ophot = _Track(
                    _OPTICAL, trackid=2, parentid=1,
                    point=_Point(pos0 + 2.0 * pdir, (0.0, 1.0, 0.0),
                                 t0 + 0.01, 2.5e-6),
                    polarization=(0.0, 0.0, 1.0),
                    creator=_Process('Cerenkov'))
                cls = self.stacking.ClassifyNewTrack(ophot)
                assert cls == _Classification.fKill
                # a non-optical secondary must pass through untouched
                esec = _Track(_PARTICLES['e-'], trackid=3, parentid=1,
                              point=p1)
                assert self.stacking.ClassifyNewTrack(esec) \
                    == _Classification.fUrgent

    class _Factory(object):
        @staticmethod
        def CreateRunManager(kind):
            return _RunManager()

    class _RMType(object):
        Serial = 'serial'

    g4.G4RunManagerFactory = _Factory
    g4.G4RunManagerType = _RMType
    return g4


def install():
    """Install the fake into sys.modules (idempotent); returns it."""
    fake = make_fake()
    sys.modules['geant4_pybind'] = fake
    return fake
