"""Wavefront photon propagation: the physics core, branch-free.

Re-engineering of the reference device physics (reference:
chroma/cuda/photon.h) for a vector machine.  Where the CUDA code is a
per-thread state machine with early returns, here every photon in the
batch advances one *step* per call through a lattice of disjoint
outcome masks combined with jnp.where:

  fill_state      -> MBVH closest hit + material/surface decode
                     (reference photon.h:83)
  propagate_to_boundary
                  -> sample absorption/scattering exponentials, pick
                     absorb/scatter/boundary outcome (photon.h:193);
                     rejection loops become closed-form truncated
                     exponentials, multi-component reemission CDFs
                     become inverse-CDF table lookups
  propagate_at_surface
                  -> DEFAULT / COMPLEX thin-film / WLS / DICHROIC
                     models (photon.h:672), statically gated by which
                     models the geometry actually uses
  propagate_at_boundary
                  -> polarization-resolved Fresnel with s/p branch
                     selection and total internal reflection
                     (photon.h:310)

RNG is counter-based threefry: one key per step, one (N, NDRAWS)
uniform block, so propagation is reproducible and shardable (no
persistent per-thread RNG state like curand XORWOW).
"""
from functools import partial

import jax
import jax.numpy as jnp

from chroma_jax import event
from chroma_jax.ops import mbvh
from chroma_jax.ops.intersect import dot, cross, norm, normalize

SPEED_OF_LIGHT = 299.792458  # mm/ns
PI = 3.141592653589793
WEIGHT_LOWER_THRESHOLD = 1e-4

# draw-block slots
NDRAWS = 20
(U_ABSORB, U_SCATTER, U_COMP, U_REEMIT, U_REEMIT_WVL, U_REEMIT_TIME,
 U_SPHERE1A, U_SPHERE1B, U_SPHERE2A, U_SPHERE2B, U_RAYL_COS, U_RAYL_PHI,
 U_POL_BRANCH, U_REFLECT, U_SURFACE, U_SURFACE2, U_DIFF1, U_DIFF2,
 U_WLS, U_SPARE) = range(NDRAWS)


def sext_byte(x):
    """Sign-extend the low byte (reference: chroma/cuda/photon.h:68)."""
    x = x.astype(jnp.int32) & 0xFF
    return jnp.where(x >= 0x80, x - 256, x)


def rotate(a, phi, n):
    """Rodrigues rotation of vectors ``a`` by angle phi about axis n
    (reference: chroma/cuda/rotate.h:21)."""
    cos_phi = jnp.cos(phi)[..., None]
    sin_phi = jnp.sin(phi)[..., None]
    return (a * cos_phi + n * dot(a, n)[..., None] * (1 - cos_phi)
            + cross(a, n) * sin_phi)


def uniform_sphere(u1, u2):
    """Uniform unit vectors from two uniforms (reference:
    chroma/cuda/random.h uniform_sphere)."""
    theta = 2.0 * PI * u1
    z = 2.0 * u2 - 1.0
    c = jnp.sqrt(jnp.maximum(1.0 - z * z, 0.0))
    return jnp.stack([c * jnp.cos(theta), c * jnp.sin(theta), z], axis=-1)


def pick_new_direction(axis, theta, phi):
    """Direction at polar angle (theta, phi) relative to ``axis``
    (reference: chroma/cuda/photon.h:137, from SNOMAN rayscatter)."""
    cos_theta, sin_theta = jnp.cos(theta), jnp.sin(theta)
    cos_phi, sin_phi = jnp.cos(phi), jnp.sin(phi)
    ax, ay, az = axis[..., 0], axis[..., 1], axis[..., 2]
    sin_axis_theta = jnp.sqrt(jnp.maximum(1.0 - az * az, 0.0))
    degenerate = sin_axis_theta < 1e-5
    safe = jnp.where(degenerate, 1.0, sin_axis_theta)
    cos_axis_phi = jnp.where(degenerate, 1.0, ax / safe)
    sin_axis_phi = jnp.where(degenerate, 0.0, ay / safe)
    dirx = cos_theta * ax + sin_theta * (
        az * cos_phi * cos_axis_phi - sin_phi * sin_axis_phi)
    diry = cos_theta * ay + sin_theta * (
        cos_phi * az * sin_axis_phi + sin_phi * cos_axis_phi)
    dirz = cos_theta * az - sin_theta * cos_phi * sin_axis_theta
    return jnp.stack([dirx, diry, dirz], axis=-1)


def cosine_hemisphere(normal, u1, u2, tangent_seed):
    """Cosine-weighted directions about ``normal`` — the direct-sampled
    equivalent of the reference's rejection loop (photon.h:379)."""
    # branch-free orthonormal basis from the normal
    t1 = normalize(cross(normal, tangent_seed))
    t2 = cross(normal, t1)
    phi = 2.0 * PI * u1
    r = jnp.sqrt(u2)
    z = jnp.sqrt(jnp.maximum(1.0 - u2, 0.0))
    return (r * jnp.cos(phi))[..., None] * t1 \
        + (r * jnp.sin(phi))[..., None] * t2 + z[..., None] * normal


def _interp(tables, table, idx, wavelength):
    """Wavelength-interpolated lookup of a stacked (K, W) table at row
    ``idx`` (reference: chroma/cuda/geometry.h interp_property)."""
    w0, dw, nw = tables.wavelength0, tables.wavelength_step, \
        tables.nwavelengths
    x = jnp.clip((wavelength - w0) / dw, 0.0, nw - 1.0)
    jl = jnp.clip(x.astype(jnp.int32), 0, nw - 2)
    f = x - jl
    flat = table.reshape(-1)
    base = idx * nw + jl
    lo = flat[base]
    hi = flat[base + 1]
    return lo + (hi - lo) * f


def _interp_rows(tables, stacked, idx, wavelength):
    """Wavelength-interpolated fetch of a (K, W, P) property stack at
    per-photon row ``idx``: ONE paired row gather returns all P
    properties, replacing P separate _interp calls (the service-pass
    cost is dominated by gather count, not bytes — ARCHITECTURE.md).
    The stack itself is built at trace time from loop-invariant tables
    (a few hundred rows), so XLA hoists it out of the step loop."""
    w0, dw, nw = tables.wavelength0, tables.wavelength_step, \
        tables.nwavelengths
    x = jnp.clip((wavelength - w0) / dw, 0.0, nw - 1.0)
    jl = jnp.clip(x.astype(jnp.int32), 0, nw - 2)
    f = x - jl
    flat = stacked.reshape(-1, stacked.shape[-1])
    base = idx * nw + jl
    lo = flat[base]
    hi = flat[base + 1]
    return lo + (hi - lo) * f[:, None]


def _sample_icdf_flat(icdf, row_idx, u):
    """Sample a stacked inverse-CDF table (R, NU) at per-photon rows."""
    nu = icdf.shape[-1]
    x = u * (nu - 1)
    j = jnp.clip(x.astype(jnp.int32), 0, nu - 2)
    f = x - j
    flat = icdf.reshape(-1)
    base = row_idx * nu + j
    lo = flat[base]
    hi = flat[base + 1]
    return lo + (hi - lo) * f


def make_photon_state(n=None, pos=None, dir=None, pol=None, wavelength=None,
                      t=None, weight=None, flags=None, last_hit_triangle=None,
                      evidx=None):
    """SoA photon state dict (device arrays).

    ``index`` records each photon's original batch position; the
    compaction driver sorts the batch for coherence and uses it to
    restore upload order afterwards (photons_end[i] must correspond to
    photons_beg[i], as in the reference)."""
    n = n if n is not None else pos.shape[0]

    def arr(x, default, shape, dtype):
        if x is None:
            return jnp.full(shape, default, dtype)
        return jnp.asarray(x, dtype)

    return dict(
        pos=arr(pos, 0.0, (n, 3), jnp.float32),
        dir=arr(dir, 0.0, (n, 3), jnp.float32),
        pol=arr(pol, 0.0, (n, 3), jnp.float32),
        wavelength=arr(wavelength, 0.0, (n,), jnp.float32),
        t=arr(t, 0.0, (n,), jnp.float32),
        weight=arr(weight, 1.0, (n,), jnp.float32),
        flags=arr(flags, 0, (n,), jnp.uint32),
        last_hit_triangle=arr(last_hit_triangle, -1, (n,), jnp.int32),
        evidx=arr(evidx, 0, (n,), jnp.uint32),
        index=jnp.arange(n, dtype=jnp.uint32),
    )


def _fresnel(state, normal, n1, n2, u_branch, u_reflect):
    """Polarization-resolved Fresnel refraction/reflection
    (reference: chroma/cuda/photon.h:310 propagate_at_boundary).

    Returns (new_dir, new_pol, reflected_mask)."""
    d = state['dir']
    pol = state['pol']
    cos_i = jnp.clip(dot(normal, -d), -1.0, 1.0)
    incident_angle = jnp.arccos(cos_i)
    sin_i = jnp.sin(incident_angle)
    sin_r = sin_i * n1 / n2
    tir = sin_r > 1.0
    refracted_angle = jnp.arcsin(jnp.clip(sin_r, -1.0, 1.0))

    ipn = cross(d, normal)
    ipn_len = norm(ipn)
    # normal incidence: use the polarization as the plane normal
    ipn = jnp.where((ipn_len < 1e-6)[..., None], pol,
                    ipn / jnp.where(ipn_len < 1e-6, 1.0, ipn_len)[..., None])

    normal_coefficient = dot(pol, ipn)
    s_fraction = normal_coefficient * normal_coefficient
    s_branch = u_branch < s_fraction

    # reflection coefficients (avoid 0/0 at normal incidence)
    sum_angle = incident_angle + refracted_angle
    diff_angle = incident_angle - refracted_angle
    near_normal = sum_angle < 1e-6
    r_s = jnp.where(near_normal, (n1 - n2) / (n1 + n2),
                    -jnp.sin(diff_angle)
                    / jnp.where(near_normal, 1.0, jnp.sin(sum_angle)))
    tan_sum = jnp.tan(sum_angle)
    r_p = jnp.where(near_normal, (n1 - n2) / (n1 + n2),
                    jnp.tan(diff_angle)
                    / jnp.where(jnp.abs(tan_sum) < 1e-20, 1.0, tan_sum))
    # tan(sum) -> inf at Brewster-complement: r_p -> 0 there, which the
    # divide handles; explicit guard above keeps NaNs out.
    r = jnp.where(s_branch, r_s, r_p)
    reflect = tir | (u_reflect < r * r)

    # reflected direction: mirror about the normal
    d_reflect = d + 2.0 * cos_i[..., None] * normal
    # refracted direction: Snell vector form
    eta = n1 / n2
    cos_r = jnp.cos(refracted_angle)
    d_refract = eta[..., None] * d \
        + (eta * cos_i - cos_r)[..., None] * normal

    new_dir = jnp.where(reflect[..., None], d_reflect, d_refract)
    # s-polarized: polarization stays normal to the plane of incidence;
    # p-polarized: in-plane, perpendicular to the new direction
    pol_s = ipn
    pol_p = normalize(cross(ipn, new_dir))
    new_pol = jnp.where(s_branch[..., None], pol_s, pol_p)
    return new_dir, new_pol, reflect


def _rayleigh(state, u_cos, u_phi):
    """Polarization-correct Rayleigh scattering (reference:
    chroma/cuda/photon.h:167, SNOMAN algorithm).  Returns (dir, pol)."""
    pol = state['pol']
    cos_theta = 2.0 * jnp.cos((jnp.arccos(1.0 - 2.0 * u_cos) - 2 * PI) / 3.0)
    cos_theta = jnp.clip(cos_theta, -1.0, 1.0)
    theta = jnp.arccos(cos_theta)
    phi = 2.0 * PI * u_phi

    new_dir = pick_new_direction(pol, theta, phi)
    near_pole = 1.0 - jnp.abs(cos_theta) < 1e-6
    pol_pole = pick_new_direction(pol, jnp.full_like(theta, PI / 2.0), phi)
    pol_gen = pol - cos_theta[..., None] * new_dir
    new_pol = jnp.where(near_pole[..., None], pol_pole, pol_gen)
    return normalize(new_dir), normalize(new_pol)


@partial(jax.jit, static_argnames=('use_weights',))
def propagate_step(state, geom, key, scatter_first, use_weights=False):
    """Advance every live photon by one step.  Returns new state.

    (The round-1 traversal-cap-with-retry experiment is gone: the
    cascade-shrinking walk in ops/mbvh.py handles the lock-step tail
    correctly and faster, so capping no longer has a role.)
    """
    n = state['pos'].shape[0]
    flags = state['flags']
    alive0 = (flags & jnp.uint32(event.TERMINAL_FLAGS)) == 0

    u = jax.random.uniform(key, (n, NDRAWS), dtype=jnp.float32)

    # NaN guard (reference: chroma/cuda/propagate.cu:262)
    bad = jnp.isnan(jnp.sum(state['dir'], axis=1)
                    + jnp.sum(state['pos'], axis=1))
    flags = jnp.where(alive0 & bad,
                      flags | jnp.uint32(event.NO_HIT | event.NAN_ABORT),
                      flags)
    active = alive0 & ~bad

    # ---- fill_state: closest hit + material decode -------------------
    res = mbvh.intersect_mesh(state['pos'], state['dir'], geom,
                              state['last_hit_triangle'], active=active)
    return physics_update(state, res, geom, u, flags, active,
                          alive0 & bad, scatter_first,
                          use_weights=use_weights)


def physics_update(state, res, geom, u, flags, active, nan_mask,
                   scatter_first, use_weights=False):
    """The physics half of a step: consume a traversal result ``res``
    (triangle/distance/normal/material_code/incomplete) and return the
    advanced photon state.  Split out of propagate_step so the fused
    walker driver (ops/fused.py) can interleave traversal iterations
    and physics at its own cadence.

    ``scatter_first`` may be a scalar or a per-photon (n,) array (the
    fused engine passes per-lane values, since lanes sit at different
    step counts).  Reference physics: chroma/cuda/photon.h.
    """
    n = state['pos'].shape[0]
    alive = active & ~res['incomplete']
    tri = res['triangle']
    d_bound = res['distance']
    hit = alive & (tri >= 0)
    flags = jnp.where(alive & ~hit, flags | jnp.uint32(event.NO_HIT), flags)

    code = res['material_code']
    inner_idx = sext_byte(code >> jnp.uint32(24))
    outer_idx = sext_byte(code >> jnp.uint32(16))
    surface_idx = sext_byte(code >> jnp.uint32(8))

    raw_normal = normalize(res['normal'])
    outside_in = dot(raw_normal, -state['dir']) > 0.0
    m1 = jnp.where(outside_in, outer_idx, inner_idx)
    m2 = jnp.where(outside_in, inner_idx, outer_idx)
    m1 = jnp.clip(m1, 0, geom.refractive_index.shape[0] - 1)
    m2 = jnp.clip(m2, 0, geom.refractive_index.shape[0] - 1)
    normal = jnp.where(outside_in[..., None], raw_normal, -raw_normal)

    wl = state['wavelength']
    bulk = jnp.stack([geom.refractive_index, geom.absorption_length,
                      geom.scattering_length], axis=-1)
    bvals = _interp_rows(geom, bulk, m1, wl)
    n1 = bvals[:, 0]
    absorption_length = bvals[:, 1]
    scattering_length = bvals[:, 2]
    n2 = _interp(geom, geom.refractive_index, m2, wl)

    # ---- propagate_to_boundary --------------------------------------
    eps = 1e-20
    absorption_distance = -absorption_length * jnp.log(u[:, U_ABSORB] + eps)
    scattering_distance = -scattering_length * jnp.log(u[:, U_SCATTER] + eps)

    weight = state['weight']
    if use_weights:
        prevent_absorb = weight > WEIGHT_LOWER_THRESHOLD
        absorption_distance = jnp.where(prevent_absorb, 1e30,
                                        absorption_distance)
    else:
        prevent_absorb = jnp.zeros(n, bool)

    # forced / forbidden first-interaction scattering, via closed-form
    # truncated exponentials (replaces the reference's rejection loops,
    # photon.h:205-232)
    scatter_prob = 1.0 - jnp.exp(-d_bound / scattering_length)
    force = (scatter_first == 1) & (scatter_prob > WEIGHT_LOWER_THRESHOLD)
    sd_forced = -scattering_length * jnp.log1p(
        -u[:, U_SCATTER] * scatter_prob)
    no_scatter_prob = jnp.exp(-d_bound / scattering_length)
    forbid = (scatter_first == -1) \
        & (no_scatter_prob > WEIGHT_LOWER_THRESHOLD)
    sd_forbidden = d_bound - scattering_length * jnp.log(
        u[:, U_SCATTER] + eps)
    scattering_distance = jnp.where(force, sd_forced, scattering_distance)
    scattering_distance = jnp.where(forbid, sd_forbidden,
                                    scattering_distance)
    weight = jnp.where(hit & force, weight * scatter_prob, weight)
    weight = jnp.where(hit & forbid, weight * no_scatter_prob, weight)

    absorb_evt = hit & (absorption_distance <= scattering_distance) \
        & (absorption_distance <= d_bound)
    scatter_evt = hit & ~absorb_evt \
        & (scattering_distance < absorption_distance) \
        & (scattering_distance <= d_bound)
    boundary_evt = hit & ~absorb_evt & ~scatter_evt

    event_dist = jnp.where(absorb_evt, absorption_distance,
                           jnp.where(scatter_evt, scattering_distance,
                                     d_bound))
    event_dist = jnp.where(hit, event_dist, 0.0)
    pos = state['pos'] + event_dist[..., None] * state['dir']
    t = state['t'] + event_dist * n1 / SPEED_OF_LIGHT

    if use_weights:
        # per-photon weighting is disabled below the threshold, exactly
        # as the reference flips its local use_weights off
        # (photon.h:200-203)
        weight = jnp.where((scatter_evt | boundary_evt) & prevent_absorb,
                           weight * jnp.exp(-event_dist
                                            / absorption_length), weight)

    dirv = state['dir']
    pol = state['pol']
    new_wl = wl
    lht = jnp.where(hit, tri, state['last_hit_triangle'])

    # ---- bulk absorption / reemission --------------------------------
    if geom.has_reemission:
        # pick the absorbing component: cumulative abs/comp_abs vs u
        # (reference photon.h:245-252)
        cum = jnp.zeros(n)
        comp_sel = jnp.zeros(n, jnp.int32)
        chosen = jnp.zeros(n, bool)
        for ci in range(geom.max_comp):
            comp_abs = _interp(geom,
                               geom.comp_absorption_length.reshape(
                                   -1, geom.nwavelengths),
                               m1 * geom.max_comp + ci, wl)
            cum = cum + absorption_length / comp_abs
            in_range = ci < geom.num_comp[m1]
            take = ~chosen & in_range & (
                (u[:, U_COMP] < cum)
                | (ci + 1 >= geom.num_comp[m1]))
            comp_sel = jnp.where(take, ci, comp_sel)
            chosen = chosen | take
        reemit_prob = _interp(geom,
                              geom.comp_reemission_prob.reshape(
                                  -1, geom.nwavelengths),
                              m1 * geom.max_comp + comp_sel, wl)
        has_comp = geom.num_comp[m1] > 0
        reemit = absorb_evt & has_comp & (u[:, U_REEMIT] < reemit_prob)
        dead_absorb = absorb_evt & ~reemit

        icdf_row = m1 * geom.max_comp + comp_sel
        re_wl = _sample_icdf_flat(
            geom.comp_reemission_wvl_icdf.reshape(-1, geom.nu),
            icdf_row, u[:, U_REEMIT_WVL])
        re_dt = _sample_icdf_flat(
            geom.comp_reemission_time_icdf.reshape(-1, geom.nu),
            icdf_row, u[:, U_REEMIT_TIME])
        re_dir = uniform_sphere(u[:, U_SPHERE1A], u[:, U_SPHERE1B])
        re_pol = normalize(cross(uniform_sphere(u[:, U_SPHERE2A],
                                                u[:, U_SPHERE2B]), re_dir))
        new_wl = jnp.where(reemit, re_wl, new_wl)
        t = jnp.where(reemit, t + re_dt, t)
        dirv = jnp.where(reemit[..., None], re_dir, dirv)
        pol = jnp.where(reemit[..., None], re_pol, pol)
        flags = jnp.where(reemit, flags | jnp.uint32(event.BULK_REEMIT),
                          flags)
    else:
        reemit = jnp.zeros(n, bool)
        dead_absorb = absorb_evt

    flags = jnp.where(dead_absorb, flags | jnp.uint32(event.BULK_ABSORB),
                      flags)
    lht = jnp.where(absorb_evt | scatter_evt, -1, lht)

    # ---- Rayleigh scattering ----------------------------------------
    ray_dir, ray_pol = _rayleigh(state, u[:, U_RAYL_COS], u[:, U_RAYL_PHI])
    dirv = jnp.where(scatter_evt[..., None], ray_dir, dirv)
    pol = jnp.where(scatter_evt[..., None], ray_pol, pol)
    flags = jnp.where(scatter_evt,
                      flags | jnp.uint32(event.RAYLEIGH_SCATTER), flags)

    # ---- surface interaction ----------------------------------------
    # outcome masks feeding the Fresnel stage
    to_fresnel = boundary_evt
    dead = jnp.zeros(n, bool)

    if geom.has_surfaces:
        s_idx = jnp.clip(surface_idx, 0, geom.surf_detect.shape[0] - 1)
        at_surface = boundary_evt & (surface_idx >= 0)
        model = geom.surf_model[s_idx]

        tangent_seed = uniform_sphere(u[:, U_SPHERE2A], u[:, U_SPHERE2B])
        diff_dir = cosine_hemisphere(normal, u[:, U_DIFF1], u[:, U_DIFF2],
                                     tangent_seed)
        diff_pol = normalize(cross(tangent_seed, diff_dir))
        cos_i = jnp.clip(dot(normal, -state['dir']), -1.0, 1.0)
        spec_dir = state['dir'] + 2.0 * cos_i[..., None] * normal

        spack = jnp.stack([geom.surf_detect, geom.surf_absorb,
                           geom.surf_reflect_diffuse,
                           geom.surf_reflect_specular], axis=-1)
        svals = _interp_rows(geom, spack, s_idx, wl)
        detect_p = svals[:, 0]
        absorb_p = svals[:, 1]
        rdiff_p = svals[:, 2]
        rspec_p = svals[:, 3]

        # ---------- DEFAULT model (photon.h:684) ----------------------
        is_default = at_surface & (model == 0)
        dp, ap, rd, rs = detect_p, absorb_p, rdiff_p, rspec_p
        if use_weights:
            reweight = (weight > WEIGHT_LOWER_THRESHOLD) \
                & (ap < 1.0 - WEIGHT_LOWER_THRESHOLD)
            survive = 1.0 - ap
            dp = jnp.where(reweight, dp / survive, dp)
            rd = jnp.where(reweight, rd / survive, rd)
            rs = jnp.where(reweight, rs / survive, rs)
            ap = jnp.where(reweight, 0.0, ap)
            weight = jnp.where(is_default & reweight, weight * survive,
                               weight)
            w_detect = is_default & (dp > 0.0)
            weight = jnp.where(w_detect, weight * dp, weight)
            flags = jnp.where(w_detect,
                              flags | jnp.uint32(event.SURFACE_DETECT),
                              flags)
            dead = dead | w_detect
            is_default = is_default & ~w_detect

        us = u[:, U_SURFACE]
        df_absorb = is_default & (us < ap)
        df_detect = is_default & ~df_absorb & (us < ap + dp)
        df_diffuse = is_default & (us >= ap + dp) & (us < ap + dp + rd)
        df_spec = is_default & (us >= ap + dp + rd) \
            & (us < ap + dp + rd + rs)
        df_pass = is_default & (us >= ap + dp + rd + rs)

        flags = jnp.where(df_absorb,
                          flags | jnp.uint32(event.SURFACE_ABSORB), flags)
        flags = jnp.where(df_detect,
                          flags | jnp.uint32(event.SURFACE_DETECT), flags)
        dead = dead | df_absorb | df_detect

        diffuse_out = df_diffuse
        spec_out = df_spec
        surf_pass = df_pass

        # ---------- WLS model (photon.h:592) --------------------------
        if geom.has_wls:
            is_wls = at_surface & (model == 2)
            reemit_p = _interp(geom, geom.surf_reemit, s_idx, wl)
            ap_w, rd_w, rs_w = absorb_p, rdiff_p, rspec_p
            if use_weights:
                reweight = (weight > WEIGHT_LOWER_THRESHOLD) \
                    & (ap_w < 1.0 - WEIGHT_LOWER_THRESHOLD)
                survive = 1.0 - ap_w
                rd_w = jnp.where(reweight, rd_w / survive, rd_w)
                rs_w = jnp.where(reweight, rs_w / survive, rs_w)
                weight = jnp.where(is_wls & reweight, weight * survive,
                                   weight)
                ap_w = jnp.where(reweight, 0.0, ap_w)
            wls_absorbed = is_wls & (us < ap_w)
            wls_reemit = wls_absorbed & (u[:, U_WLS] < reemit_p)
            wls_dead = wls_absorbed & ~wls_reemit
            wls_reflect = is_wls & ~wls_absorbed \
                & (us < ap_w + rs_w + rd_w)
            wls_pass = is_wls & ~wls_absorbed & ~wls_reflect
            # reflection type choice, defaulting to diffuse
            ur = u[:, U_SURFACE2] * (rs_w + rd_w)
            wls_spec = wls_reflect & (ur < rs_w)
            wls_diff = wls_reflect & ~wls_spec

            re_wl2 = _sample_icdf_flat(geom.surf_reemission_icdf,
                                       s_idx, u[:, U_REEMIT_WVL])
            re_dir2 = uniform_sphere(u[:, U_SPHERE1A], u[:, U_SPHERE1B])
            re_pol2 = normalize(cross(tangent_seed, re_dir2))
            new_wl = jnp.where(wls_reemit, re_wl2, new_wl)
            dirv = jnp.where(wls_reemit[..., None], re_dir2, dirv)
            pol = jnp.where(wls_reemit[..., None], re_pol2, pol)
            flags = jnp.where(wls_reemit,
                              flags | jnp.uint32(event.SURFACE_REEMIT),
                              flags)
            flags = jnp.where(wls_dead,
                              flags | jnp.uint32(event.SURFACE_ABSORB),
                              flags)
            flags = jnp.where(wls_pass,
                              flags | jnp.uint32(event.SURFACE_TRANSMIT),
                              flags)
            dead = dead | wls_dead
            diffuse_out = diffuse_out | wls_diff
            spec_out = spec_out | wls_spec
            surf_pass = surf_pass | wls_pass

        # ---------- dichroic model (photon.h:640) ---------------------
        if geom.has_dichroic:
            is_dich = at_surface & (model == 3)
            angle = jnp.arccos(cos_i)
            A = geom.dichroic_angles.shape[1]
            angles_ph = geom.dichroic_angles[s_idx]          # (N,A)
            na = geom.dichroic_nangles[s_idx]
            # fractional index into the angle grid
            below = jnp.sum(
                (angle[:, None] >= angles_ph)
                & (jnp.arange(A)[None, :] < na[:, None]), axis=1) - 1
            iidx = jnp.clip(below, 0, jnp.maximum(na - 2, 0))
            a_lo = jnp.sum(jnp.where(jnp.arange(A)[None, :] == iidx[:, None],
                                     angles_ph, 0), axis=1)
            a_hi = jnp.sum(
                jnp.where(jnp.arange(A)[None, :] == (iidx + 1)[:, None],
                          angles_ph, 0), axis=1)
            frac = jnp.clip((angle - a_lo)
                            / jnp.where(a_hi > a_lo, a_hi - a_lo, 1.0),
                            0.0, 1.0)
            iidx_hi = jnp.where(iidx < na - 2, iidx + 1, iidx)
            W = geom.nwavelengths
            refl2d = geom.dichroic_reflect.reshape(-1, W)
            tran2d = geom.dichroic_transmit.reshape(-1, W)
            r_lo = _interp(geom, refl2d, s_idx * A + iidx, wl)
            r_hi = _interp(geom, refl2d, s_idx * A + iidx_hi, wl)
            t_lo = _interp(geom, tran2d, s_idx * A + iidx, wl)
            t_hi = _interp(geom, tran2d, s_idx * A + iidx_hi, wl)
            refl_prob = r_lo + (r_hi - r_lo) * frac
            tran_prob = t_lo + (t_hi - t_lo) * frac

            dich_spec = is_dich & (us < refl_prob)
            dich_pass = is_dich & ~dich_spec & (us < refl_prob + tran_prob)
            dich_dead = is_dich & ~dich_spec & ~dich_pass
            flags = jnp.where(dich_pass,
                              flags | jnp.uint32(event.SURFACE_TRANSMIT),
                              flags)
            flags = jnp.where(dich_dead,
                              flags | jnp.uint32(event.SURFACE_ABSORB),
                              flags)
            dead = dead | dich_dead
            spec_out = spec_out | dich_spec
            surf_pass = surf_pass | dich_pass

        # ---------- complex thin-film model (photon.h:400) ------------
        if geom.has_complex:
            is_cpx = at_surface & (model == 1)
            (cp_dead_detect, cp_dead_absorb, cp_diff, cp_spec, cp_transmit,
             cp_dir, cp_pol, weight) = _propagate_complex(
                 geom, state, s_idx, wl, normal, n1, n2, weight, u,
                 use_weights, is_cpx)
            flags = jnp.where(cp_dead_detect,
                              flags | jnp.uint32(event.SURFACE_DETECT),
                              flags)
            flags = jnp.where(cp_dead_absorb,
                              flags | jnp.uint32(event.SURFACE_ABSORB),
                              flags)
            flags = jnp.where(cp_transmit,
                              flags | jnp.uint32(event.SURFACE_TRANSMIT),
                              flags)
            dead = dead | cp_dead_detect | cp_dead_absorb
            diffuse_out = diffuse_out | cp_diff
            spec_out = spec_out | cp_spec
            # complex transmit refracts within the model (CONTINUE)
            dirv = jnp.where(cp_transmit[..., None], cp_dir, dirv)
            pol = jnp.where(cp_transmit[..., None], cp_pol, pol)

        # apply shared reflection outcomes
        dirv = jnp.where(diffuse_out[..., None], diff_dir, dirv)
        pol = jnp.where(diffuse_out[..., None], diff_pol, pol)
        flags = jnp.where(diffuse_out,
                          flags | jnp.uint32(event.REFLECT_DIFFUSE), flags)
        dirv = jnp.where(spec_out[..., None], spec_dir, dirv)
        flags = jnp.where(spec_out,
                          flags | jnp.uint32(event.REFLECT_SPECULAR), flags)

        to_fresnel = boundary_evt & ((surface_idx < 0) | surf_pass)

    # ---- Fresnel boundary crossing ----------------------------------
    fr_dir, fr_pol, fr_reflected = _fresnel(state, normal, n1, n2,
                                            u[:, U_POL_BRANCH],
                                            u[:, U_REFLECT])
    dirv = jnp.where(to_fresnel[..., None], fr_dir, dirv)
    pol = jnp.where(to_fresnel[..., None], fr_pol, pol)
    flags = jnp.where(to_fresnel & fr_reflected,
                      flags | jnp.uint32(event.REFLECT_SPECULAR), flags)

    # freeze state of photons that were not (effectively) alive this
    # step; NaN-aborted photons keep only their new terminal flags
    def keep(old, new):
        mask = alive
        if new.ndim == 2:
            mask = mask[..., None]
        return jnp.where(mask, new, old)

    flag_mask = alive | nan_mask
    return dict(
        pos=keep(state['pos'], pos),
        dir=keep(state['dir'], dirv),
        pol=keep(state['pol'], pol),
        wavelength=keep(state['wavelength'], new_wl),
        t=keep(state['t'], t),
        weight=keep(state['weight'], weight),
        flags=jnp.where(flag_mask, flags, state['flags']),
        last_hit_triangle=keep(state['last_hit_triangle'], lht),
        evidx=state['evidx'],
        index=state['index'],
    )


def thin_film_rta(n1r, n2_eta, n2_k, n3r, cos_t1, wl, thickness):
    """Three-layer thin-film reflect/transmit probabilities.

    Pure optics of the PMT window model (reference:
    chroma/cuda/photon.h:400): layer 1 (real index ``n1r``) /
    absorbing film (complex ``n2_eta + i n2_k``, ``thickness`` mm) /
    layer 3 (real ``n3r``), photon incident from layer 1 at
    ``cos_t1`` with wavelength ``wl`` nm.  Returns
    (s_r, s_t, p_r, p_t, n_r, n_t): R and T for s-, p-polarization
    and for normal incidence (the QE normalization).  Absorption in
    the film is 1 - R - T.  Validated against an independent
    complex128 transfer-matrix implementation in
    tests/test_propagation.py::test_thin_film_transfer_matrix.
    """
    j = jnp.complex64(1j)
    one = jnp.complex64(1.0)
    n1 = n1r.astype(jnp.complex64)
    n2 = n2_eta + j * n2_k
    n3 = n3r.astype(jnp.complex64)

    theta = jnp.arccos(jnp.clip(cos_t1, -1.0, 1.0))
    cos1 = jnp.cos(theta).astype(jnp.complex64)
    sin1 = jnp.sin(theta).astype(jnp.complex64)

    e = 2.0 * PI * thickness * 1.0e6 / wl  # mm -> nm

    cos3 = jnp.sqrt(one - (n1 / n3) ** 2 * sin1 ** 2)
    cos2 = jnp.sqrt(one - (n1 / n2) ** 2 * sin1 ** 2)
    n2cos2 = n2 * cos2
    uu = jnp.real(n2cos2)
    vv = jnp.imag(n2cos2)

    def rt(r12, r23, t12, t23, g, u_, v_):
        exp1 = jnp.exp(2.0 * v_ * e)
        exp2 = 1.0 / exp1
        ar12, ar23 = jnp.abs(r12), jnp.abs(r23)
        arg12 = jnp.angle(r12)
        arg23 = jnp.angle(r23)
        denom = exp1 + ar12 ** 2 * ar23 ** 2 * exp2 \
            + 2.0 * ar12 * ar23 * jnp.cos(arg23 + arg12 + 2.0 * u_ * e)
        r = (ar12 ** 2 * exp1 + ar23 ** 2 * exp2
             + 2.0 * ar12 * ar23 * jnp.cos(arg23 - arg12 + 2.0 * u_ * e)) \
            / denom
        t = jnp.real(g) * jnp.abs(t12) ** 2 * jnp.abs(t23) ** 2 / denom
        return r, t

    # s polarization
    s_n1c1, s_n2c2, s_n3c3 = n1 * cos1, n2 * cos2, n3 * cos3
    s_r, s_t = rt((s_n1c1 - s_n2c2) / (s_n1c1 + s_n2c2),
                  (s_n2c2 - s_n3c3) / (s_n2c2 + s_n3c3),
                  2.0 * s_n1c1 / (s_n1c1 + s_n2c2),
                  2.0 * s_n2c2 / (s_n2c2 + s_n3c3),
                  s_n3c3 / s_n1c1, uu, vv)
    # p polarization
    p_n2c1, p_n3c2 = n2 * cos1, n3 * cos2
    p_n2c3, p_n1c2 = n2 * cos3, n1 * cos2
    p_r, p_t = rt((p_n2c1 - p_n1c2) / (p_n2c1 + p_n1c2),
                  (p_n3c2 - p_n2c3) / (p_n3c2 + p_n2c3),
                  2.0 * n1 * cos1 / (p_n2c1 + p_n1c2),
                  2.0 * n2 * cos2 / (p_n3c2 + p_n2c3),
                  (n3 * cos3) / (n1 * cos1), uu, vv)
    # normal incidence (for QE scaling)
    n_r, n_t = rt((n1 - n2) / (n1 + n2), (n2 - n3) / (n2 + n3),
                  2.0 * n1 / (n1 + n2), 2.0 * n2 / (n2 + n3),
                  n3 / n1, n2_eta, n2_k)
    return s_r, s_t, p_r, p_t, n_r, n_t


def _propagate_complex(geom, state, s_idx, wl, normal, n1r, n3r, weight, u,
                       use_weights, is_cpx):
    """Thin-film PMT optical model with complex refractive index
    (reference: chroma/cuda/photon.h:400 propagate_complex, adapted
    from the RAT PMT optical model)."""
    detect = _interp(geom, geom.surf_detect, s_idx, wl)
    reflect_diffuse = _interp(geom, geom.surf_reflect_diffuse, s_idx, wl)
    n2_eta = _interp(geom, geom.surf_eta, s_idx, wl)
    n2_k = _interp(geom, geom.surf_k, s_idx, wl)
    thickness = geom.surf_thickness[s_idx]
    transmissive = geom.surf_transmissive[s_idx] != 0

    d = state['dir']
    cos_t1 = jnp.abs(dot(d, normal))
    theta = jnp.arccos(jnp.clip(cos_t1, -1.0, 1.0))
    s_r, s_t, p_r, p_t, n_r, n_t = thin_film_rta(
        n1r, n2_eta, n2_k, n3r, cos_t1, wl, thickness)

    # s-polarization fraction, same construction as propagate_at_boundary
    ipn = cross(d, normal)
    ipn_len = norm(ipn)
    ipn = jnp.where((ipn_len < 1e-6)[..., None], state['pol'],
                    ipn / jnp.where(ipn_len < 1e-6, 1.0, ipn_len)[..., None])
    s_fraction = dot(state['pol'], ipn) ** 2

    transmit = s_fraction * s_t + (1.0 - s_fraction) * p_t
    transmit_n = n_t
    transmit = jnp.where(transmissive, transmit, 0.0)
    transmit_n = jnp.where(transmissive, transmit_n, 0.0)
    reflect = s_fraction * s_r + (1.0 - s_fraction) * p_r
    absorb = 1.0 - transmit - reflect
    absorb_n = 1.0 - transmit_n - n_r

    # scale detection efficiency by normal-incidence absorption
    detect = detect / jnp.where(jnp.abs(absorb_n) > 1e-12, absorb_n, 1.0)

    dead_detect = jnp.zeros_like(is_cpx)
    if use_weights:
        reweight = (weight > WEIGHT_LOWER_THRESHOLD) \
            & (absorb < 1.0 - WEIGHT_LOWER_THRESHOLD)
        survive = 1.0 - absorb
        weight = jnp.where(is_cpx & reweight, weight * survive, weight)
        detect = jnp.where(reweight, detect / survive, detect)
        reflect = jnp.where(reweight, reflect / survive, reflect)
        transmit = jnp.where(reweight, transmit / survive, transmit)
        absorb = jnp.where(reweight, 0.0, absorb)
        w_det = is_cpx & (detect > 0.0)
        weight = jnp.where(w_det, weight * detect, weight)
        dead_detect = w_det
        is_cpx = is_cpx & ~w_det

    us = u[:, U_SURFACE]
    absorbed = is_cpx & (us < absorb)
    cp_detect = absorbed & (u[:, U_SURFACE2] < detect)
    cp_absorb = absorbed & ~cp_detect
    reflected = is_cpx & ~absorbed \
        & ((us < absorb + reflect) | ~transmissive)
    cp_diff = reflected & (u[:, U_REFLECT] < reflect_diffuse)
    cp_spec = reflected & ~cp_diff
    cp_transmit = is_cpx & ~absorbed & ~reflected

    # transmission refracts n1 -> n3
    cos_i = jnp.clip(dot(normal, -d), -1.0, 1.0)
    sin_r = jnp.sin(theta) * n1r / n3r
    cos_r = jnp.sqrt(jnp.maximum(1.0 - sin_r ** 2, 0.0))
    eta = n1r / n3r
    cp_dir = eta[..., None] * d + (eta * cos_i - cos_r)[..., None] * normal
    cp_pol = normalize(cross(ipn, cp_dir))

    return (dead_detect | cp_detect, cp_absorb, cp_diff, cp_spec,
            cp_transmit, cp_dir, cp_pol, weight)
