"""Physics-grade particle transport and optical-photon generation.

This is the Geant4-free backend of the generator pool: it reproduces,
at parameterization grade, the behavior of the reference's Geant4 path
(reference: src/G4chroma.cc — EM physics list + photon interception at
creation; src/GLG4Scint.cc — Birks-quenched scintillation with
arbitrary spectra and time profiles; chroma/generator/g4gen.py — world
material from a chroma Material).

Physics content (all native, no Geant4):

* Heavy charged particles (mu, pi, K, p, alpha): Bethe-Bloch stopping
  power with the Sternheimer asymptotic density correction, CSDA range
  by integration, straight-line transport with Highland multiple
  -scattering deflections, Frank-Tamm Cherenkov emission per step with
  the material's wavelength-dependent refractive index.
* Electrons/positrons: Berger-Seltzer-style collision stopping power
  (Moller terms) plus ~E/X0 radiative losses.  Below the shower
  threshold they are tracked like heavy particles (with MCS and
  radiated energy handed to child gammas); above it an analytic EM
  shower parameterization (PDG longitudinal gamma profile, Moliere
  transverse spread) converts the shower's total above-threshold track
  length into Cherenkov photons.
* Gammas: pair/Compton conversion at an energy-dependent interaction
  depth, handing energy to electrons (showers above threshold).
* Scintillation: mean photons = light_yield x Birks-quenched energy
  deposit (GLG4Scint.cc:264-280 behavior), spectrum sampled from
  ``scintillation_spectrum``, delay from ``scintillation_waveform``
  (sum-of-exponentials when time constants are given) plus
  ``scintillation_rise_time``.

Units follow the framework: mm, ns, MeV, nm.
"""
import numpy as np

from chroma_jax import event
from chroma_jax.event import PARTICLE_MASS_MEV, Steps
from chroma_jax.sample import uniform_sphere
from chroma_jax.transform import normalize, get_perp

# physical constants
ME = 0.510998950            # electron mass, MeV
ALPHA_FS = 1.0 / 137.035999
K_BETHE = 0.307075          # MeV cm^2 / mol (4 pi N_A re^2 me c^2)
C_MM_NS = 299.792458        # speed of light, mm/ns
TWO_PI_ALPHA_NM = 2.0 * np.pi * ALPHA_FS * 1e6   # 2*pi*alpha in 1/mm*nm

# element data: Z, A (g/mol), mean excitation energy I (eV)
ELEMENTS = {
    'H': (1, 1.008, 19.2),   'B': (5, 10.81, 76.0),
    'C': (6, 12.011, 78.0),  'N': (7, 14.007, 82.0),
    'O': (8, 15.999, 95.0),  'F': (9, 18.998, 115.0),
    'Na': (11, 22.990, 149.0), 'Mg': (12, 24.305, 156.0),
    'Al': (13, 26.982, 166.0), 'Si': (14, 28.085, 173.0),
    'P': (15, 30.974, 173.0), 'S': (16, 32.06, 180.0),
    'Cl': (17, 35.45, 174.0), 'K': (19, 39.098, 190.0),
    'Ca': (20, 40.078, 191.0), 'Ti': (22, 47.867, 233.0),
    'Fe': (26, 55.845, 286.0), 'Cu': (29, 63.546, 322.0),
    'Gd': (64, 157.25, 591.0), 'Pb': (82, 207.2, 823.0),
}

PARTICLE_CHARGE = {
    'e-': -1, 'e+': 1, 'mu-': -1, 'mu+': 1, 'pi+': 1, 'pi-': -1,
    'kaon+': 1, 'kaon-': -1, 'proton': 1, 'alpha': 2,
}
PARTICLE_MASS_MEV.setdefault('kaon+', 493.677)
PARTICLE_MASS_MEV.setdefault('kaon-', 493.677)

WATER_COMPOSITION = {'H': 0.1119, 'O': 0.8881}


class EMMedium(object):
    """Electromagnetic transport properties derived from a chroma
    Material's density and mass composition (water defaults)."""

    def __init__(self, material):
        density = getattr(material, 'density', 0.0) or 1.0
        comp = getattr(material, 'composition', None) or WATER_COMPOSITION
        self.density = float(density)

        w = np.array([comp[e] for e in comp], float)
        w = w / w.sum()
        Z = np.array([ELEMENTS[e][0] for e in comp], float)
        A = np.array([ELEMENTS[e][1] for e in comp], float)
        I = np.array([ELEMENTS[e][2] for e in comp], float)

        self.zoa = float(np.sum(w * Z / A))               # <Z/A>
        self.lnI = float(np.sum(w * Z / A * np.log(I)) / self.zoa)
        # Bragg additivity underestimates I for condensed compounds
        # (ICRU 37); the standard ~13% chemical-binding correction puts
        # water at 78 eV vs the ICRU 79.7
        if len(w) > 1:
            self.lnI += np.log(1.13)
        self.I_eV = float(np.exp(self.lnI))
        self.zeff = float(np.sum(w * Z))
        self.aeff = float(np.sum(w * A))

        # radiation length (PDG approximate): 1/X0 = sum w_i / X0_i
        x0i = 716.4 * A / (Z * (Z + 1.0) * np.log(287.0 / np.sqrt(Z)))
        self.X0_gcm2 = float(1.0 / np.sum(w / x0i))
        self.X0_mm = self.X0_gcm2 / self.density * 10.0
        # critical energy (electrons, liquids/solids) and Moliere radius
        zsum = float(np.sum(w * Z * Z / A) / np.sum(w * Z / A))
        self.Ec_MeV = 610.0 / (zsum + 1.24)
        self.moliere_mm = self.X0_mm * 21.2 / self.Ec_MeV
        # plasma energy for the density correction, eV
        self.plasma_eV = 28.816 * np.sqrt(self.density * self.zoa)

    # ---- stopping powers (MeV / mm) ----------------------------------
    def heavy_dedx(self, ke, mass, z=1):
        """Bethe-Bloch with asymptotic Sternheimer density correction."""
        ke = np.asarray(ke, float)
        gamma = 1.0 + ke / mass
        beta2 = np.clip(1.0 - 1.0 / gamma ** 2, 1e-12, 1.0)
        bg = np.sqrt(beta2) * gamma
        tmax = (2.0 * ME * bg ** 2
                / (1.0 + 2.0 * gamma * ME / mass + (ME / mass) ** 2))
        I_MeV = self.I_eV * 1e-6
        delta = np.maximum(
            2.0 * (np.log(self.plasma_eV / self.I_eV) + np.log(bg) - 0.5),
            0.0) * (bg > 1.0)
        arg = 2.0 * ME * bg ** 2 * tmax / I_MeV ** 2
        dedx = (K_BETHE * z * z * self.zoa / beta2
                * (0.5 * np.log(np.maximum(arg, 1.0 + 1e-9))
                   - beta2 - delta / 2.0))
        # clamp to a sane low-energy plateau (Bethe invalid at very low E)
        dedx = np.maximum(dedx, 0.1)
        return dedx * self.density / 10.0       # MeV cm^2/g -> MeV/mm

    def electron_dedx_collision(self, ke):
        """Berger-Seltzer (Moller) collision stopping power for e-."""
        ke = np.maximum(np.asarray(ke, float), 1e-4)
        tau = ke / ME
        gamma = tau + 1.0
        beta2 = np.clip(1.0 - 1.0 / gamma ** 2, 1e-12, 1.0)
        bg = np.sqrt(beta2) * gamma
        I_MeV = self.I_eV * 1e-6
        fterm = (1.0 - beta2
                 + (tau ** 2 / 8.0 - (2.0 * tau + 1.0) * np.log(2.0))
                 / gamma ** 2)
        delta = np.maximum(
            2.0 * (np.log(self.plasma_eV / self.I_eV) + np.log(bg) - 0.5),
            0.0) * (bg > 1.0)
        arg = tau ** 2 * (tau + 2.0) / (2.0 * (I_MeV / ME) ** 2)
        dedx = (0.5 * K_BETHE * self.zoa / beta2
                * (np.log(np.maximum(arg, 1.0 + 1e-9)) + fterm - delta))
        dedx = np.maximum(dedx, 0.01)
        return dedx * self.density / 10.0

    def electron_dedx_radiative(self, ke):
        """Radiative loss ~ E_total/X0 with a soft low-energy rolloff."""
        etot = np.asarray(ke, float) + ME
        supp = etot / (etot + 2.0)          # ~E/(E+2MeV) screening rolloff
        return etot * supp / self.X0_mm


def _birks_constant_mm(material):
    """Birks constant in mm/MeV from ``scintillation_mod``.

    GLG4Scint reads its Birks constant out of the SCINTMOD property
    (GLG4Scint.cc:723-733, entry index 1, Geant4 units mm/MeV).
    Accepts a dict ({'birks': v}), a sequence (index 1), or a scalar.
    """
    mod = getattr(material, 'scintillation_mod', None)
    if mod is None:
        return 0.0
    if isinstance(mod, dict):
        return float(mod.get('birks', 0.0))
    arr = np.atleast_1d(np.asarray(mod, float)).ravel()
    if arr.size >= 2:
        return float(arr[1])
    return float(arr[0])


class CherenkovTable(object):
    """Frank-Tamm yields and wavelength sampling over the material's
    refractive-index table (emission over the full RINDEX range, as
    Geant4's Cherenkov process does)."""

    def __init__(self, refractive_index):
        ri = np.asarray(refractive_index, float)
        lam = np.linspace(ri[:, 0].min(), ri[:, 0].max(), 256)
        n = np.interp(lam, ri[:, 0], ri[:, 1])
        self.lam = lam
        self.n = n
        self.n_max = float(n.max())

    def dndx(self, beta):
        """Photons per mm of track at velocity ``beta`` (scalar or (N,))."""
        beta = np.atleast_1d(np.asarray(beta, float))
        sin2 = 1.0 - 1.0 / np.clip(
            (beta[:, None] * self.n[None, :]) ** 2, 1e-12, None)
        integ = np.trapezoid(np.maximum(sin2, 0.0) / self.lam ** 2,
                             self.lam, axis=1)
        return TWO_PI_ALPHA_NM * integ

    def sample_wavelengths(self, beta, rng, chunk=1 << 18):
        """Per-photon wavelengths for per-photon velocities ``beta``."""
        beta = np.asarray(beta, float)
        out = np.empty(len(beta), np.float32)
        for s in range(0, len(beta), chunk):
            b = beta[s:s + chunk]
            sin2 = np.maximum(
                1.0 - 1.0 / np.clip((b[:, None] * self.n[None, :]) ** 2,
                                    1e-12, None), 0.0)
            pdf = sin2 / self.lam[None, :] ** 2
            cdf = np.cumsum(pdf, axis=1)
            u = rng.uniform(0.0, 1.0, len(b)) * cdf[:, -1]
            idx = np.minimum((cdf < u[:, None]).sum(axis=1),
                             len(self.lam) - 2)
            # linear within the winning bin
            lo = np.where(idx > 0, cdf[np.arange(len(b)), idx - 1], 0.0)
            hi = cdf[np.arange(len(b)), idx]
            f = np.clip((u - lo) / np.maximum(hi - lo, 1e-30), 0.0, 1.0)
            out[s:s + chunk] = (self.lam[idx]
                                + f * (self.lam[idx + 1] - self.lam[idx]))
        return out


class ScintillationModel(object):
    """GLG4Scint-equivalent scintillation: Birks quenching, spectrum
    CDF, waveform delays (GLG4Scint.cc:224-386 behavior)."""

    def __init__(self, material):
        self.light_yield = float(
            getattr(material, 'scintillation_light_yield', None) or 0.0)
        self.birks_mm = _birks_constant_mm(material)
        self.rise_ns = float(
            getattr(material, 'scintillation_rise_time', None) or 0.0)

        spec = getattr(material, 'scintillation_spectrum', None)
        if spec is not None:
            spec = np.asarray(spec, float)
            cdf = np.cumsum(np.maximum(spec[:, 1], 0.0))
            self._spec_lam = spec[:, 0]
            self._spec_cdf = cdf / cdf[-1]
        else:
            self._spec_lam = None

        wf = getattr(material, 'scintillation_waveform', None)
        self._decay_tau = None
        self._decay_amp = None
        self._wf_t = None
        if wf is not None:
            wf = np.asarray(wf, float)
            if np.all(wf[:, 0] <= 0.0):
                # sum of exponentials: (-tau, amplitude) rows
                self._decay_tau = -wf[:, 0]
                amp = np.maximum(wf[:, 1], 0.0)
                self._decay_amp = amp / amp.sum()
            else:
                cdf = np.cumsum(np.maximum(wf[:, 1], 0.0))
                self._wf_t = wf[:, 0]
                self._wf_cdf = cdf / cdf[-1]

    @property
    def active(self):
        return self.light_yield > 0.0 and self._spec_lam is not None

    def quenched(self, edep, dedx_mm):
        """Birks-quenched energy deposit (GLG4Scint.cc:264-269)."""
        if self.birks_mm == 0.0:
            return edep
        return edep / (1.0 + self.birks_mm * dedx_mm)

    def sample_wavelengths(self, n, rng):
        u = rng.uniform(0.0, 1.0, n)
        return np.interp(u, self._spec_cdf, self._spec_lam)

    def sample_delays(self, n, rng):
        if self._decay_tau is not None:
            comp = rng.choice(len(self._decay_tau), size=n,
                              p=self._decay_amp)
            dt = rng.exponential(self._decay_tau[comp])
        elif self._wf_t is not None:
            dt = np.interp(rng.uniform(0.0, 1.0, n), self._wf_cdf,
                           self._wf_t)
        else:
            dt = np.zeros(n)
        if self.rise_ns > 0.0:
            dt += rng.exponential(self.rise_ns, n)
        return dt


def scintillate_step(model, rng, pre_pos, post_pos, t0, t1, edep):
    """Scintillation photons for ONE particle step under GLG4Scint
    semantics (reference: src/GLG4Scint.cc:264-386 PostPostStepDoIt):
    dE/dx = edep/steplength feeds Birks quenching, the photon count is
    Poisson(light_yield * qedep), emission points are uniform along
    the step, directions isotropic, polarization random transverse,
    wavelengths/delays from the material's spectrum/waveform tables.

    Returns ``(qedep, photons-or-None)``; used by the Geant4 stepping
    action (g4gen.py) and unit-testable without Geant4.
    """
    pre = np.asarray(pre_pos, float)
    post = np.asarray(post_pos, float)
    seg = post - pre
    ds = float(np.linalg.norm(seg))
    edep = float(edep)
    if edep <= 0.0:
        return 0.0, None
    dedx_mm = edep / max(ds, 1e-9)
    qedep = model.quenched(edep, dedx_mm)
    if not model.active:
        return qedep, None
    n = int(rng.poisson(model.light_yield * qedep))
    if n == 0:
        return qedep, None
    frac = rng.uniform(0.0, 1.0, n)
    pos = pre[None, :] + frac[:, None] * seg[None, :]
    t = float(t0) + frac * (float(t1) - float(t0)) \
        + model.sample_delays(n, rng)
    pdir = uniform_sphere(n)
    pol = np.cross(uniform_sphere(n), pdir)
    pol /= np.maximum(np.linalg.norm(pol, axis=1)[:, None], 1e-12)
    wl = model.sample_wavelengths(n, rng)
    return qedep, event.Photons(
        pos=pos.astype(np.float32), dir=pdir.astype(np.float32),
        pol=pol.astype(np.float32), wavelengths=wl.astype(np.float32),
        t=t.astype(np.float32),
        flags=np.full(n, event.SCINTILLATION, np.uint32))


def fabjan_fraction(z):
    """F(z) = 1 + z*e^z*Ei(-z); fraction of shower track length above
    threshold (Fabjan 1985 parameterization)."""
    from scipy.special import exp1
    z = float(z)
    if z <= 0.0:
        return 1.0
    if z >= 50.0:
        return 0.0
    # Ei(-z) = -E1(z)
    return float(np.clip(1.0 - z * np.exp(z) * exp1(z), 0.0, 1.0))


class TrackGenerator(object):
    """Native particle transport + optical photon generation.

    Drop-in replacement for the reference G4Generator interface
    (chroma/generator/g4gen.py:64): ``generate_photons(vertices)``
    returns an ``event.Photons`` batch; each vertex gains ``.steps``
    (track polyline with edep/qedep) and gamma conversions appear as
    ``.children``.
    """

    # e+/e- above this KE use the analytic shower; below, stepping
    SHOWER_THRESHOLD_MEV = 50.0
    GAMMA_CUTOFF_MEV = 0.1          # drop gammas below this
    TRACK_CUTOFF_MEV = 0.2          # stop stepping below this KE
    STEP_FRACTION = 0.02            # target fractional KE loss per step
    MIN_STEP_MM = 0.05
    MAX_STEP_MM = 30.0
    # mean polar angle (rad) of shower-electron directions about the
    # shower axis (tunable parameterization; gives the familiar fuzzy
    # Cherenkov ring of EM showers)
    SHOWER_ANGLE_RAD = 0.25

    def __init__(self, material, rng=None, seed=None):
        self.material = material
        if rng is None:
            rng = np.random.RandomState(seed)
        self.rng = rng
        self.em = EMMedium(material)
        ri = np.asarray(material.refractive_index, float)
        self.cherenkov = CherenkovTable(ri)
        self.scint = ScintillationModel(material)
        # Cherenkov kinetic threshold for electrons in this medium
        nmax = self.cherenkov.n_max
        if nmax > 1.0:
            self.e_thresh_ke = ME * (1.0 / np.sqrt(1.0 - 1.0 / nmax ** 2)
                                     - 1.0)
        else:
            self.e_thresh_ke = np.inf

    # ------------------------------------------------------------------
    def generate_photons(self, vertices, mute=False, max_depth=6):
        parts = []
        for v in vertices:
            parts.extend(self._vertex_photons(v, depth=0,
                                              max_depth=max_depth))
            for child in (v.children or []):
                p = self.generate_photons([child], mute=mute)
                if len(p):
                    parts.append(p)
        parts = [p for p in parts if p is not None and len(p)]
        if not parts:
            return event.Photons()
        return event.Photons.join(parts)

    # ------------------------------------------------------------------
    def _vertex_photons(self, v, depth, max_depth):
        name = v.particle_name
        if name == 'gamma':
            return self._gamma(v, depth, max_depth)
        if name in ('e-', 'e+'):
            if v.ke >= self.SHOWER_THRESHOLD_MEV:
                return self._em_shower(v, v.ke, offset_mm=0.0,
                                       is_gamma=False)
            return self._charged_track(v, ME,
                                       PARTICLE_CHARGE.get(name, -1),
                                       electron=True, depth=depth,
                                       max_depth=max_depth)
        mass = PARTICLE_MASS_MEV.get(name)
        zq = PARTICLE_CHARGE.get(name)
        if mass is None or zq is None or name in ('neutron', 'pi0'):
            # neutral / unknown: no direct optical production
            return []
        return self._charged_track(v, mass, zq, electron=False,
                                   depth=depth, max_depth=max_depth)

    # ---- charged-particle stepping -----------------------------------
    def _charged_track(self, v, mass, zq, electron, depth, max_depth):
        rng = self.rng
        em = self.em
        ke0 = float(v.ke)
        pos0 = np.asarray(v.pos, float)
        dir0 = normalize(np.asarray(v.dir, float))

        # energy grid along the track: fixed fractional-loss stepping
        kes = [ke0]
        steps = []
        ke = ke0
        while ke > self.TRACK_CUTOFF_MEV and len(steps) < 20000:
            if electron:
                dedx_c = float(em.electron_dedx_collision(ke))
                dedx_r = float(em.electron_dedx_radiative(ke))
            else:
                dedx_c = float(em.heavy_dedx(ke, mass, abs(zq)))
                dedx_r = 0.0
            dedx = dedx_c + dedx_r
            ds = np.clip(self.STEP_FRACTION * ke / dedx,
                         self.MIN_STEP_MM, self.MAX_STEP_MM)
            de = min(dedx * ds, ke)
            ds = de / dedx
            steps.append((ds, de, dedx_c, dedx_r))
            ke -= de
            kes.append(ke)
        if not steps:
            return []

        ds = np.array([s[0] for s in steps])
        de = np.array([s[1] for s in steps])
        dedx_c = np.array([s[2] for s in steps])
        dedx_r = np.array([s[3] for s in steps])
        ke_mid = (np.array(kes[:-1]) + np.array(kes[1:])) / 2.0
        gamma = 1.0 + ke_mid / mass
        beta = np.sqrt(np.clip(1.0 - 1.0 / gamma ** 2, 0.0, 1.0))
        p_mom = np.sqrt(np.maximum(ke_mid * (ke_mid + 2.0 * mass), 1e-12))

        # Highland multiple scattering as a transverse random walk
        xr = ds / em.X0_mm
        theta0 = (13.6 / np.maximum(beta * p_mom, 1e-6) * abs(zq)
                  * np.sqrt(xr)
                  * (1.0 + 0.038 * np.log(np.maximum(
                      xr * zq * zq / np.maximum(beta ** 2, 1e-6), 1e-12))))
        theta0 = np.clip(np.nan_to_num(theta0), 0.0, 0.5)
        t1 = normalize(get_perp(dir0))
        t2 = np.cross(dir0, t1)
        kx = np.cumsum(rng.normal(0.0, theta0))
        ky = np.cumsum(rng.normal(0.0, theta0))
        dirs = (dir0[None, :] + kx[:, None] * t1[None, :]
                + ky[:, None] * t2[None, :])
        dirs /= np.linalg.norm(dirs, axis=1)[:, None]

        seg = dirs * ds[:, None]
        ends = pos0[None, :] + np.cumsum(seg, axis=0)
        starts = np.vstack([pos0, ends[:-1]])
        dt = ds / (np.maximum(beta, 1e-6) * C_MM_NS)
        t_start = float(v.t0) + np.concatenate([[0.0], np.cumsum(dt)[:-1]])

        # collision deposit scintillates; radiative energy -> child gammas
        edep = de * (dedx_c / np.maximum(dedx_c + dedx_r, 1e-12))
        erad = de - edep
        # terminal sub-cutoff energy deposits locally
        edep_total = edep.copy()
        edep_total[-1] += kes[-1]
        qedep = self.scint.quenched(edep_total, dedx_c)

        v.steps = Steps(x=starts[:, 0], y=starts[:, 1], z=starts[:, 2],
                        t=t_start, dx=dirs[:, 0], dy=dirs[:, 1],
                        dz=dirs[:, 2], ke=ke_mid, edep=edep_total,
                        qedep=qedep)

        parts = []
        ch = self._cherenkov_from_steps(starts, dirs, ds, beta, t_start)
        if ch is not None:
            parts.append(ch)
        sc = self._scint_from_steps(starts, dirs, ds, beta, t_start, qedep)
        if sc is not None:
            parts.append(sc)

        # bremsstrahlung children (electrons only): lump radiated energy
        # into a few 1/k-spectrum gammas along the upper track
        e_brem = float(erad.sum())
        if electron and e_brem > self.GAMMA_CUTOFF_MEV and \
                depth < max_depth:
            children = []
            remaining = e_brem
            # emission points weighted by radiated energy per step
            wcdf = np.cumsum(erad)
            wcdf = wcdf / max(wcdf[-1], 1e-30)
            while remaining > self.GAMMA_CUTOFF_MEV:
                # 1/k spectrum between cutoff and remaining
                lo = self.GAMMA_CUTOFF_MEV
                eg = lo * (remaining / lo) ** rng.uniform()
                eg = min(eg, remaining)
                i = int(np.searchsorted(wcdf, rng.uniform()))
                i = min(i, len(starts) - 1)
                g = event.Vertex('gamma', starts[i], dirs[i], eg,
                                 t0=t_start[i])
                children.append(g)
                remaining -= eg
            v.children = (v.children or []) + children
            for g in children:
                parts.extend(self._gamma(g, depth + 1, max_depth))
        return parts

    def _cherenkov_from_steps(self, starts, dirs, ds, beta, t_start):
        rng = self.rng
        dndx = self.cherenkov.dndx(beta)
        mean = dndx * ds
        total = rng.poisson(mean.sum())
        if total == 0:
            return None
        cdf = np.cumsum(mean)
        pick = np.searchsorted(cdf, rng.uniform(0.0, cdf[-1], total))
        pick = np.minimum(pick, len(ds) - 1)
        frac = rng.uniform(0.0, 1.0, total)
        pos = starts[pick] + (frac * ds[pick])[:, None] * dirs[pick]
        t = t_start[pick] + frac * ds[pick] / (
            np.maximum(beta[pick], 1e-6) * C_MM_NS)
        wl = self.cherenkov.sample_wavelengths(beta[pick], rng)
        n_at = np.interp(wl, self.cherenkov.lam, self.cherenkov.n)
        cos_c = np.clip(1.0 / (beta[pick] * n_at), -1.0, 1.0)
        sin_c = np.sqrt(1.0 - cos_c ** 2)
        phi = rng.uniform(0.0, 2.0 * np.pi, total)
        d = dirs[pick]
        a1 = np.cross(d, np.where(np.abs(d[:, 2:3]) < 0.9,
                                  [[0.0, 0.0, 1.0]], [[1.0, 0.0, 0.0]]))
        a1 /= np.linalg.norm(a1, axis=1)[:, None]
        a2 = np.cross(d, a1)
        pdir = (cos_c[:, None] * d
                + sin_c[:, None] * (np.cos(phi)[:, None] * a1
                                    + np.sin(phi)[:, None] * a2))
        # polarization in the (track, photon) plane
        pol = np.cross(pdir, np.cross(d, pdir))
        pol /= np.maximum(np.linalg.norm(pol, axis=1)[:, None], 1e-12)
        return event.Photons(
            pos=pos.astype(np.float32), dir=pdir.astype(np.float32),
            pol=pol.astype(np.float32), wavelengths=wl.astype(np.float32),
            t=t.astype(np.float32),
            flags=np.full(total, event.CHERENKOV, np.uint32))

    def _scint_from_steps(self, starts, dirs, ds, beta, t_start, qedep):
        if not self.scint.active:
            return None
        rng = self.rng
        mean = self.scint.light_yield * qedep
        total = rng.poisson(mean.sum())
        if total == 0:
            return None
        cdf = np.cumsum(mean)
        pick = np.searchsorted(cdf, rng.uniform(0.0, cdf[-1], total))
        pick = np.minimum(pick, len(ds) - 1)
        frac = rng.uniform(0.0, 1.0, total)
        pos = starts[pick] + (frac * ds[pick])[:, None] * dirs[pick]
        t = (t_start[pick]
             + frac * ds[pick] / (np.maximum(beta[pick], 1e-6) * C_MM_NS)
             + self.scint.sample_delays(total, rng))
        pdir = uniform_sphere(total)
        pol = np.cross(uniform_sphere(total), pdir)
        pol /= np.maximum(np.linalg.norm(pol, axis=1)[:, None], 1e-12)
        wl = self.scint.sample_wavelengths(total, rng)
        return event.Photons(
            pos=pos.astype(np.float32), dir=pdir.astype(np.float32),
            pol=pol.astype(np.float32), wavelengths=wl.astype(np.float32),
            t=t.astype(np.float32),
            flags=np.full(total, event.SCINTILLATION, np.uint32))

    # ---- EM shower parameterization ----------------------------------
    def _em_shower(self, v, energy, offset_mm, is_gamma):
        """Analytic EM shower: PDG longitudinal profile, Moliere
        transverse spread, Cherenkov from the above-threshold track
        length, scintillation from the quenched energy deposit."""
        rng = self.rng
        em = self.em
        e_tot = float(energy) + (0.0 if is_gamma else ME)
        y = max(e_tot / em.Ec_MeV, 1.01)
        b = 0.5
        a = 1.0 + b * (np.log(y) + (0.5 if is_gamma else -0.5))

        axis = normalize(np.asarray(v.dir, float))
        origin = np.asarray(v.pos, float) + offset_mm * axis
        a1 = normalize(get_perp(axis))
        a2 = np.cross(axis, a1)

        # total charged track length above the Cherenkov threshold
        z_th = 4.58 * self.e_thresh_ke * self.em.zeff \
            / (self.em.aeff * em.Ec_MeV)
        f_above = fabjan_fraction(z_th)
        track_mm = f_above * e_tot / em.Ec_MeV * em.X0_mm

        dndx = float(self.cherenkov.dndx(1.0)[0])
        n_ch = rng.poisson(track_mm * dndx)

        parts = []
        if n_ch > 0:
            pos, pdir, t = self._shower_points(origin, axis, a1, a2, a, b,
                                               n_ch, float(v.t0))
            wl = self.cherenkov.sample_wavelengths(
                np.ones(n_ch), rng)
            n_at = np.interp(wl, self.cherenkov.lam, self.cherenkov.n)
            cos_c = np.clip(1.0 / n_at, -1.0, 1.0)
            sin_c = np.sqrt(1.0 - cos_c ** 2)
            phi = rng.uniform(0.0, 2.0 * np.pi, n_ch)
            b1 = np.cross(pdir, np.where(np.abs(pdir[:, 2:3]) < 0.9,
                                         [[0.0, 0.0, 1.0]],
                                         [[1.0, 0.0, 0.0]]))
            b1 /= np.linalg.norm(b1, axis=1)[:, None]
            b2 = np.cross(pdir, b1)
            gdir = (cos_c[:, None] * pdir
                    + sin_c[:, None] * (np.cos(phi)[:, None] * b1
                                        + np.sin(phi)[:, None] * b2))
            pol = np.cross(gdir, np.cross(pdir, gdir))
            pol /= np.maximum(np.linalg.norm(pol, axis=1)[:, None], 1e-12)
            parts.append(event.Photons(
                pos=pos.astype(np.float32), dir=gdir.astype(np.float32),
                pol=pol.astype(np.float32),
                wavelengths=wl.astype(np.float32), t=t.astype(np.float32),
                flags=np.full(n_ch, event.CHERENKOV, np.uint32)))

        if self.scint.active:
            # shower electrons deposit at roughly the minimum-ionizing
            # collision rate; quench accordingly
            dedx_mip = float(self.em.electron_dedx_collision(
                2.0 * em.Ec_MeV))
            q = self.scint.quenched(e_tot, dedx_mip)
            n_sc = rng.poisson(self.scint.light_yield * q)
            if n_sc > 0:
                pos, _, t = self._shower_points(origin, axis, a1, a2, a, b,
                                                n_sc, float(v.t0))
                t = t + self.scint.sample_delays(n_sc, rng)
                pdir = uniform_sphere(n_sc)
                pol = np.cross(uniform_sphere(n_sc), pdir)
                pol /= np.maximum(
                    np.linalg.norm(pol, axis=1)[:, None], 1e-12)
                wl = self.scint.sample_wavelengths(n_sc, rng)
                parts.append(event.Photons(
                    pos=pos.astype(np.float32),
                    dir=pdir.astype(np.float32),
                    pol=pol.astype(np.float32),
                    wavelengths=wl.astype(np.float32),
                    t=t.astype(np.float32),
                    flags=np.full(n_sc, event.SCINTILLATION, np.uint32)))
        return parts

    def _shower_points(self, origin, axis, a1, a2, a, b, n, t0):
        """Sample emission points and local e- directions in a shower."""
        rng = self.rng
        em = self.em
        depth = rng.gamma(a, 1.0 / b, n) * em.X0_mm        # longitudinal
        # two-component transverse profile in Moliere units
        core = rng.uniform(0.0, 1.0, n) < 0.82
        r = np.where(core, rng.exponential(0.13, n),
                     rng.exponential(0.60, n)) * em.moliere_mm
        phi = rng.uniform(0.0, 2.0 * np.pi, n)
        pos = (origin[None, :] + depth[:, None] * axis[None, :]
               + (r * np.cos(phi))[:, None] * a1[None, :]
               + (r * np.sin(phi))[:, None] * a2[None, :])
        # local electron direction: forward-peaked about the axis
        theta = rng.gamma(2.0, self.SHOWER_ANGLE_RAD / 2.0, n)
        psi = rng.uniform(0.0, 2.0 * np.pi, n)
        st, ct = np.sin(theta), np.cos(theta)
        pdir = (ct[:, None] * axis[None, :]
                + st[:, None] * (np.cos(psi)[:, None] * a1[None, :]
                                 + np.sin(psi)[:, None] * a2[None, :]))
        pdir /= np.linalg.norm(pdir, axis=1)[:, None]
        t = t0 + depth / C_MM_NS
        return pos, pdir, t

    # ---- gammas -------------------------------------------------------
    # mean interaction free path in water-equivalent media, g/cm^2
    _GAMMA_MFP_E = np.array([0.1, 0.5, 1.0, 2.0, 5.0, 10.0, 50.0, 1e3])
    _GAMMA_MFP_G = np.array([5.9, 10.3, 14.1, 20.3, 30.3, 45.1, 58.0,
                             46.0])
    # mean fraction of gamma energy given to the electron (Compton /
    # photoelectric below pair threshold)
    _GAMMA_EFRAC_E = np.array([0.1, 0.5, 1.0, 2.0, 5.0, 10.0])
    _GAMMA_EFRAC_F = np.array([0.15, 0.35, 0.44, 0.53, 0.64, 0.68])

    def _gamma(self, v, depth, max_depth):
        rng = self.rng
        e = float(v.ke)
        if e < self.GAMMA_CUTOFF_MEV or depth > max_depth:
            return []
        axis = normalize(np.asarray(v.dir, float))
        if e >= 2.0 * ME * 5.0:   # >~5 MeV: pair-dominated -> full shower
            conv = rng.exponential(9.0 / 7.0) * self.em.X0_mm
            shower_v = event.Vertex('gamma', v.pos, v.dir, e, t0=v.t0)
            parts = self._em_shower(shower_v, e, offset_mm=conv,
                                    is_gamma=True)
            return parts
        # low-energy: single interaction -> electron + residual gamma
        mfp_gcm2 = np.interp(e, self._GAMMA_MFP_E, self._GAMMA_MFP_G)
        mfp_mm = mfp_gcm2 / self.em.density * 10.0
        dist = rng.exponential(mfp_mm)
        ipos = np.asarray(v.pos, float) + dist * axis
        it0 = float(v.t0) + dist / C_MM_NS
        frac = float(np.interp(e, self._GAMMA_EFRAC_E, self._GAMMA_EFRAC_F))
        e_el = e * np.clip(rng.normal(frac, 0.15 * frac), 0.05, 0.98)
        # electron roughly forward; residual gamma re-scatters
        ev = event.Vertex('e-', ipos, axis, e_el, t0=it0)
        parts = list(self._vertex_photons(ev, depth + 1, max_depth))
        v.children = (v.children or []) + [ev]
        e_res = e - e_el
        if e_res > self.GAMMA_CUTOFF_MEV:
            gdir = normalize(axis + 0.8 * np.asarray(uniform_sphere(1))[0])
            gv = event.Vertex('gamma', ipos, gdir, e_res, t0=it0)
            v.children.append(gv)
            parts.extend(self._gamma(gv, depth + 1, max_depth))
        return parts
