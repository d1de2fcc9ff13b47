"""Single source of truth for the golden-validation configurations.

Three consumers build from THIS module, so configuration parity
between engines holds by construction rather than by careful copying:

  * tools/make_golden.py           — this engine (chroma_jax), any host
  * tools/make_golden_reference.py — the CUDA reference (chroma), on a
                                     CUDA host
  * tests/test_golden_analytic.py  — the closed-form expectations

Reference config shapes: chroma/test/test_detector.py:26-77 (bomb at
a fixed position, fixed seed, hit-time/charge histograms).
"""
import numpy as np

# ---- demo-tiny golden bomb (tests/golden/demo_tiny_pdf.npz) ----------
GOLDEN_SEED = 1234
NPHOTONS = 40000
WAVELENGTH = 400.0
BOMB_POS = (200.0, 0.0, 0.0)
NEVENTS = 8
TIME_BINS = np.linspace(0.0, 40.0, 81)
CHARGE_BINS = np.linspace(0.0, 4.0, 41)

# ---- full-demo golden (tests/golden/demo_full_pdf.npz) ---------------
FULL_SEED = 4321
FULL_NPHOTONS = 200000
FULL_NEVENTS = 4
FULL_TIME_BINS = np.linspace(0.0, 120.0, 121)

# ---- analytic sphere (tests/test_golden_analytic.py) -----------------
# A photon bomb at the center of a sphere whose entire inner wall is
# one photocathode channel, in a non-scattering medium: every expected
# observable has a closed form (see the test's docstring).
SPHERE_R = 1000.0          # mm
SPHERE_QE = 0.25
SPHERE_SURVIVE_BULK = 0.8  # exp(-R / L_abs)
SPHERE_N = 1.4
SPHERE_T_RMS = 1.2         # ns
SPHERE_Q_MEAN = 1.0
SPHERE_Q_RMS = 0.25
SPHERE_NPHOTONS = 40000
SPHERE_NEVENTS = 6
SPHERE_WAVELENGTH = 450.0
SPHERE_SEED = 31
SPHERE_NSTEPS = 64         # sphere tessellation


def build_analytic_sphere(make, Solid, Material, Surface, Detector):
    """Build the analytic-sphere detector from an engine's own classes
    (pass chroma_jax's or reference chroma's — the APIs mirror), so
    both engines simulate the IDENTICAL configuration."""
    medium = Material('clear')
    medium.set('refractive_index', SPHERE_N)
    medium.set('absorption_length',
               SPHERE_R / np.log(1.0 / SPHERE_SURVIVE_BULK))
    medium.set('scattering_length', 1e9)

    cathode = Surface('full_cathode')
    cathode.set('detect', SPHERE_QE)
    cathode.set('absorb', 1.0 - SPHERE_QE)

    det = Detector(medium)
    det.add_pmt(Solid(make.sphere(SPHERE_R, nsteps=SPHERE_NSTEPS),
                      medium, medium, surface=cathode))
    det.set_time_dist_gaussian(SPHERE_T_RMS, -6.0 * SPHERE_T_RMS,
                               6.0 * SPHERE_T_RMS)
    det.set_charge_dist_gaussian(SPHERE_Q_MEAN, SPHERE_Q_RMS, 0.0,
                                 2.0 * SPHERE_Q_MEAN)
    return det
