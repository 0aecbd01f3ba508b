"""Wavefront path integrator with NEE + MIS + Russian roulette
(reference: src/librender/integrators/path.cpp:19-141, driver loop
integrator.cpp:82-126), and the `volpath`, `direct`, `aov` and `debug`
integrators' per-wavefront estimates (volpath.cpp, direct.cpp, aov.cpp,
debug.cpp).

The reference's per-ray recursion becomes a lockstep Python loop over
bounces on a lane-last SoA wavefront: every lane runs every stage under an
active mask. Each path bounce makes one closest-hit cast and one shadow
cast, each volpath bounce four closest-hit casts of its transmittance
march and the next closest-hit cast, all through the cluster kernels
(accel/cluster.py).

RNG discipline: every lane owns a PCG32 stream; draws happen unconditionally
in a fixed order per bounce (path: NEE 2D, BSDF 1D + 2D, RR 1D), so the
sequence is the same as `misaki_tpu.render.integrator` whatever the
masking, device or chunking.
"""

import torch

from misaki_tpu_torch.accel import traverse
from misaki_tpu_torch.bsdf import kernels as bsdf
from misaki_tpu_torch.core import frame, rng, vec
from misaki_tpu_torch.core import math as m
from misaki_tpu_torch.emitter import kernels as emitter
from misaki_tpu_torch.render import interaction as inter
from misaki_tpu_torch.render import medium as med
from misaki_tpu_torch.render import textures as tex
from misaki_tpu_torch.scene.types import (
    BSDF_NULL,
    MASK_FLAG,
    MC_KIND,
    MC_MASK,
    MC_OPACITY,
    SPEC_SLOT_COLS,
)
from misaki_tpu_torch.utils import tracing

DEFAULT_MAX_DEPTH_CAP = 16


def _ray_diff(ray):
    """Camera ray differentials, when the driver generated them."""
    if "d_dx" in ray:
        return (ray["d_dx"], ray["d_dy"])
    return None


def n_bounce_iters(scene, depth_cap=DEFAULT_MAX_DEPTH_CAP):
    """Number of NEE+BSDF bounce iterations: the reference breaks before NEE
    once depth >= max_depth (path.cpp:49-50); max_depth == -1 means
    unbounded, which is capped (RR terminates long before)."""
    if scene.max_depth > 0:
        return scene.max_depth - 1
    return depth_cap


def sample_path(scene, ray, rng_state, depth_cap=DEFAULT_MAX_DEPTH_CAP):
    """Per-wavefront radiance estimate.

    ray: dict {o, d (vec3 tuples), mint, maxt (L,), wavelengths (4, L)}.
    Returns (spectrum (4, L), rng_state).
    """
    L = ray["o"][0].shape[0]
    dev = ray["o"][0].device
    wavelengths = ray["wavelengths"]

    hit = traverse.intersect(scene, ray["o"], ray["d"], ray["mint"], ray["maxt"])
    si = inter.compute_interaction(
        scene, hit, ray["o"], ray["d"], wavelengths, ray_diff=_ray_diff(ray),
    )

    throughput = torch.ones((4, L), device=dev)
    result = torch.zeros((4, L), device=dev)
    eta = torch.ones((L,), device=dev)
    rad = emitter.radiance_all(scene, wavelengths)

    # ---- depth == 1: directly visible emitters / environment (path.cpp:34-47)
    if not scene.hide_emitters:
        if scene.has_environment:
            env = emitter.eval_environment(scene, ray["d"], wavelengths, rad)
            result = result + torch.where((~si["valid"])[None, :], env, 0.0)
        em_val = emitter.eval_emitter(scene, si["emitter"], si["wi"], si["uv"],
                                      wavelengths, rad)
        result = result + torch.where(si["valid"][None, :], em_val, 0.0)

    active = si["valid"]
    for i in range(n_bounce_iters(scene, depth_cap)):
        with tracing.span(tracing.BOUNCE):
            depth = i + 1  # the reference's loop variable

            # -------- draws (unconditional, fixed order) --------
            u_nee, rng_state = rng.next_2d(rng_state)
            u_bsdf1, rng_state = rng.next_float32(rng_state)
            u_bsdf2, rng_state = rng.next_2d(rng_state)
            u_rr, rng_state = rng.next_float32(rng_state)

            p = bsdf.material_params(scene, si["bsdf"], si["uv"], wavelengths,
                                     duv=(si["duv_dx"], si["duv_dy"]))

            # -------- NEE (path.cpp:53-67), only from Smooth BSDFs --------
            ds = emitter.sample_emitter_direct(scene, si["p"], wavelengths, u_nee, rad)
            nee_possible = active & p["smooth"] & (ds["pdf"] > 0.0)
            # shadow ray (scene.cpp:90-97); masked lanes get degenerate rays
            sh_mint = m.RayEpsilon * (1.0 + vec.max_abs(si["p"]))
            sh_maxt = ds["dist"] * (1.0 - m.ShadowEpsilon)
            occluded = traverse.ray_test(
                scene, si["p"], ds["d"],
                torch.where(nee_possible, sh_mint, 0.0),
                torch.where(nee_possible, sh_maxt, -1.0),
            )
            wo_nee = frame.to_local(si["sh"], ds["d"])
            f_nee = bsdf.eval_bsdf(p, si["wi"], wo_nee)
            pdf_nee_bsdf = bsdf.pdf_bsdf(p, si["wi"], wo_nee)
            # detached sampling: MIS weights are pdf ratios, their gradient is
            # stopped (misaki_tpu/render/integrator.py:127-129)
            mis_w = torch.where(ds["delta"], 1.0, m.mis_power2(ds["pdf"], pdf_nee_bsdf)).detach()
            contrib = throughput * ds["spec"] * f_nee * mis_w[None, :]
            take = nee_possible & ~occluded
            result = result + torch.where(take[None, :], contrib, 0.0)

            # -------- BSDF sampling (path.cpp:71-98) --------
            bs = bsdf.sample_bsdf(p, si["wi"], u_bsdf1, u_bsdf2)
            wo_world = frame.to_world(si["sh"], bs["wo"])
            new_mint = inter.spawn_ray_mint(si["p"])
            next_hit = traverse.intersect(
                scene, si["p"], wo_world,
                torch.where(active, new_mint, 0.0),
                torch.where(active, torch.inf, -1.0),
                coherent=False,
            )
            si_next = inter.compute_interaction(scene, next_hit, si["p"], wo_world, wavelengths)

            throughput = throughput * bs["weight"]
            eta = eta * bs["eta"]

            # -------- emitter-hit MIS (path.cpp:84-108) --------
            hit_area = si_next["valid"] & (si_next["emitter"] >= 0)
            em_val = emitter.eval_emitter(scene, si_next["emitter"], si_next["wi"],
                                          si_next["uv"], wavelengths, rad)
            em_pdf_area = emitter.pdf_emitter_direct(
                scene, si_next["emitter"], wo_world, si_next["t"], si_next["ng"])
            value = torch.where(hit_area[None, :], em_val, 0.0)
            em_pdf = torch.where(hit_area, em_pdf_area, 0.0)
            if scene.has_environment:
                hit_env = ~si_next["valid"]
                env_val = emitter.eval_environment(scene, wo_world, wavelengths, rad)
                value = torch.where(hit_env[None, :], env_val, value)
                env_ids = torch.full((L,), scene.environment_idx, dtype=torch.int32, device=dev)
                env_pdf = emitter.pdf_emitter_direct(scene, env_ids, wo_world, si_next["t"],
                                                     vec.neg(wo_world))
                em_pdf = torch.where(hit_env, env_pdf, em_pdf)
                hit_emitter = hit_area | hit_env
            else:
                hit_emitter = hit_area
            em_pdf = torch.where(bs["delta"], 0.0, em_pdf)
            mis_b = m.mis_power2(bs["pdf"], em_pdf).detach()
            add = throughput * value * mis_b[None, :]
            result = result + torch.where((active & hit_emitter)[None, :], add, 0.0)

            # -------- continuation --------
            active = active & bs["valid"] & si_next["valid"]

            # -------- Russian roulette (path.cpp:116-122) --------
            if depth + 1 >= scene.rr_depth:
                q = torch.clamp(throughput.amax(dim=0) * eta * eta, max=0.95).detach()
                active = active & ~(u_rr >= q)
                throughput = torch.where(active[None, :],
                                         throughput / torch.clamp(q, min=1e-8)[None, :],
                                         throughput)
            si = si_next

    return result, rng_state


AOV_NAMES = ("depth", "position", "uv", "geo_normal", "sh_normal")


def sample_aovs(scene, ray, rng_state):
    """The `aov` integrator's channel set (integrators/aov.cpp:29-144):
    depth, position, uv, geo_normal and sh_normal of the primary hit, 0 on a
    miss. Draws nothing."""
    hit = traverse.intersect(scene, ray["o"], ray["d"], ray["mint"], ray["maxt"])
    si = inter.compute_interaction(scene, hit, ray["o"], ray["d"], ray["wavelengths"])
    v = si["valid"]

    def mask(x):
        return tuple(torch.where(v, c, 0.0) for c in x)

    return {
        "depth": torch.where(v, si["t"], 0.0),
        "position": mask(si["p"]),
        "uv": mask(si["uv"]),
        "geo_normal": mask(si["ng"]),
        "sh_normal": mask(si["sh"]["n"]),
    }, rng_state


def sample_direct(scene, ray, rng_state):
    """The `direct` integrator (integrators/direct.cpp:82-137): direct
    illumination only, from max(light_samples, 1) emitter samples and
    max(bsdf_samples, 1) BSDF samples combined by the sample-count-weighted
    power-2 MIS heuristic (direct.cpp:104-110, 127-131).

    Draw order: every emitter sample's 2D, then every BSDF sample's 1D and
    2D, as misaki_tpu draws them. Each emitter sample makes one shadow cast
    and each BSDF sample one closest-hit cast."""
    L = ray["o"][0].shape[0]
    dev = ray["o"][0].device
    wavelengths = ray["wavelengths"]
    n_lum = max(scene.direct_light_samples, 1)
    n_bsdf = max(scene.direct_bsdf_samples, 1)
    frac_lum = n_lum / (n_lum + n_bsdf)
    frac_bsdf = n_bsdf / (n_lum + n_bsdf)
    w_lum, w_bsdf = 1.0 / n_lum, 1.0 / n_bsdf

    hit = traverse.intersect(scene, ray["o"], ray["d"], ray["mint"], ray["maxt"])
    si = inter.compute_interaction(scene, hit, ray["o"], ray["d"], wavelengths,
                                   ray_diff=_ray_diff(ray))
    result = torch.zeros((4, L), device=dev)
    rad = emitter.radiance_all(scene, wavelengths)

    # directly visible emitters / environment (direct.cpp:89-94)
    if not scene.hide_emitters:
        if scene.has_environment:
            env = emitter.eval_environment(scene, ray["d"], wavelengths, rad)
            result = result + torch.where((~si["valid"])[None, :], env, 0.0)
        em_val = emitter.eval_emitter(scene, si["emitter"], si["wi"], si["uv"],
                                      wavelengths, rad)
        result = result + torch.where(si["valid"][None, :], em_val, 0.0)

    active = si["valid"]
    p = bsdf.material_params(scene, si["bsdf"], si["uv"], wavelengths,
                             duv=(si["duv_dx"], si["duv_dy"]))
    sh_mint = m.RayEpsilon * (1.0 + vec.max_abs(si["p"]))

    # -------- emitter sampling (direct.cpp:97-113), from Smooth lobes --------
    for _ in range(n_lum):
        with tracing.span(tracing.BOUNCE):
            u_nee, rng_state = rng.next_2d(rng_state)
            ds = emitter.sample_emitter_direct(scene, si["p"], wavelengths, u_nee, rad)
            possible = active & p["smooth"] & (ds["pdf"] > 0.0)
            occluded = traverse.ray_test(
                scene, si["p"], ds["d"],
                torch.where(possible, sh_mint, 0.0),
                torch.where(possible, ds["dist"] * (1.0 - m.ShadowEpsilon), -1.0),
            )
            wo_nee = frame.to_local(si["sh"], ds["d"])
            f_nee = bsdf.eval_bsdf(p, si["wi"], wo_nee)
            pdf_b = bsdf.pdf_bsdf(p, si["wi"], wo_nee)
            mis = torch.where(ds["delta"], 1.0,
                              m.mis_power2(ds["pdf"] * frac_lum, pdf_b * frac_bsdf)) * w_lum
            take = possible & ~occluded
            result = result + torch.where(take[None, :], ds["spec"] * f_nee * mis[None, :], 0.0)

    # -------- BSDF sampling (direct.cpp:116-136) --------
    for _ in range(n_bsdf):
        with tracing.span(tracing.BOUNCE):
            u1, rng_state = rng.next_float32(rng_state)
            u2, rng_state = rng.next_2d(rng_state)
            bs = bsdf.sample_bsdf(p, si["wi"], u1, u2)
            wo_world = frame.to_world(si["sh"], bs["wo"])
            go = active & bs["valid"]
            hit2 = traverse.intersect(
                scene, si["p"], wo_world,
                torch.where(go, inter.spawn_ray_mint(si["p"]), 0.0),
                torch.where(go, torch.inf, -1.0),
                coherent=False,
            )
            si2 = inter.compute_interaction(scene, hit2, si["p"], wo_world, wavelengths)
            hit_area = si2["valid"] & (si2["emitter"] >= 0)
            em_val = emitter.eval_emitter(scene, si2["emitter"], si2["wi"], si2["uv"],
                                          wavelengths, rad)
            value = torch.where(hit_area[None, :], em_val, 0.0)
            em_pdf_area = emitter.pdf_emitter_direct(scene, si2["emitter"], wo_world,
                                                     si2["t"], si2["ng"])
            em_pdf = torch.where(hit_area, em_pdf_area, 0.0)
            if scene.has_environment:
                hit_env = ~si2["valid"]
                env_val = emitter.eval_environment(scene, wo_world, wavelengths, rad)
                value = torch.where(hit_env[None, :], env_val, value)
                env_ids = torch.full((L,), scene.environment_idx, dtype=torch.int32, device=dev)
                env_pdf = emitter.pdf_emitter_direct(scene, env_ids, wo_world, si2["t"],
                                                     vec.neg(wo_world))
                em_pdf = torch.where(hit_env, env_pdf, em_pdf)
                hit_em = hit_area | hit_env
            else:
                hit_em = hit_area
            em_pdf = torch.where(bs["delta"], 0.0, em_pdf)
            mis = m.mis_power2(bs["pdf"] * frac_bsdf, em_pdf * frac_lum) * w_bsdf
            result = result + torch.where((go & hit_em)[None, :],
                                          bs["weight"] * value * mis[None, :], 0.0)

    return result, rng_state


def sample_debug(scene, ray, rng_state):
    """The `debug` integrator (integrators/debug.cpp): |shading normal| as
    RGB, 0 on a miss; one closest-hit cast, no draws. The workload of the
    bunny intersection-rate benchmark."""
    hit = traverse.intersect(scene, ray["o"], ray["d"], ray["mint"], ray["maxt"])
    si = inter.compute_interaction(scene, hit, ray["o"], ray["d"], ray["wavelengths"])
    rgb = tuple(torch.where(si["valid"], torch.abs(c), 0.0) for c in si["sh"]["n"])
    return rgb, rng_state


def _attenuated_transmittance(scene, ref_p, d, dist, medium_ids, wavelengths, segments=4):
    """Scene::eval_transmittance (scene.cpp:143-184) as a fixed-segment
    march of closest-hit casts (misaki_tpu/render/integrator.py:205-307):
    a hit on a non-null BSDF blocks the shadow ray; a null hit passes it on
    (a mask surface with its 1 - opacity) after the medium-consistency
    check and the medium transition; each travelled segment multiplies in
    the current medium's transmittance. Lanes still alive after `segments`
    segments count as blocked (the reference loops without a bound).

    Returns the medium-aware transmittance (4, L), 0 where occluded."""
    L = dist.shape[0]
    tr = torch.ones((4, L), device=dist.device)
    remaining = dist
    o = ref_p
    medium = medium_ids
    alive = dist > 0.0
    params = scene.materials.params
    has_mask = MASK_FLAG in scene.bsdf_kinds
    # bitmap opacities go through the texel fetch
    opac_scene = scene if MC_OPACITY in scene.bitmap_slots else None

    for _ in range(segments):
        mint = m.RayEpsilon * (1.0 + vec.max_abs(o))
        maxt = remaining * (1.0 - m.ShadowEpsilon)
        hit = traverse.intersect(scene, o, d, torch.where(alive, mint, 0.0),
                                 torch.where(alive, maxt, -1.0), coherent=False)
        si = inter.compute_interaction(scene, hit, o, d, wavelengths)
        ids = si["bsdf"].to(torch.int64)
        kind = params[MC_KIND, ids].to(torch.int32)
        is_null = kind == BSDF_NULL
        if has_mask:
            # a mask surface transmits 1 - opacity and the march goes on
            # through it (the mask's null lobe, scene.cpp:155-183)
            is_mask = params[MC_MASK, ids] > 0.5
            opac = tex.eval_spectral_slot(params[MC_OPACITY:MC_OPACITY + SPEC_SLOT_COLS][:, ids],
                                          si["uv"], wavelengths, scene=opac_scene)
            is_null = is_null | is_mask
            tr = torch.where((alive & si["valid"] & is_mask)[None, :], tr * (1.0 - opac), tr)
        blocked = alive & si["valid"] & ~is_null
        tr = torch.where(blocked[None, :], 0.0, tr)

        # the medium's transmittance over the travelled segment
        # (scene.cpp:160-166); grid lanes march the density
        seg = torch.minimum(si["t"], remaining)
        mp = med.fetch_medium(scene, medium, wavelengths)
        tr = torch.where((alive & (medium >= 0))[None, :],
                         tr * med.transmittance_ray(scene, mp, medium, o, d, seg), tr)

        step = alive & si["valid"] & is_null
        # medium consistency and transition at a null boundary
        # (scene.cpp:172-176): the medium marched through must be the one on
        # this side of the boundary, else the path is inconsistent -> 0
        expected = inter.target_medium(si, vec.neg(d), medium)
        tr = torch.where((step & (expected != medium))[None, :], 0.0, tr)
        medium = torch.where(step, inter.target_medium(si, d, medium), medium)
        o = vec.where(step, si["p"], o)
        remaining = torch.where(step, remaining - si["t"], remaining)
        alive = step & (remaining > mint) & (tr.amax(dim=0) > 0.0)

    return torch.where(alive[None, :], 0.0, tr)


def volpath_iters(scene, depth_cap=DEFAULT_MAX_DEPTH_CAP):
    """Bounce iterations of `sample_volpath`: max_depth where it is set,
    else the cap (misaki_tpu/render/integrator.py:344-345). Each makes
    four transmittance casts and the next closest-hit cast."""
    return scene.max_depth if scene.max_depth > 0 else depth_cap


def sample_volpath(scene, ray, rng_state, depth_cap=DEFAULT_MAX_DEPTH_CAP):
    """The volumetric path tracer (integrators/volpath.cpp:21-184;
    misaki_tpu/render/integrator.py:310-511). As there:
      * one distance-sampling channel per path, drawn before the loop
        (volpath.cpp:39), one of the four hero wavelengths;
      * NEE without MIS (volpath.cpp:102-112 computes the weight and does
        not apply it), one emitter sample and one attenuated transmittance
        march shared by the medium and the surface branch;
      * emission gated by the `emitted_radiance` / `null_chain`
        bookkeeping of delta chains (volpath.cpp:121-141);
      * medium transitions at surfaces whose shape declares interior or
        exterior media (volpath.cpp:147-148).
    Draws per iteration, unconditional and in this order: distance 1D,
    NEE 2D, phase 2D, BSDF 1D + 2D, RR 1D. Gradients stop at the casts and
    the RR q, nowhere else: they flow through sampled free-flight
    distances as in misaki_tpu.

    Returns (spectrum (4, L), rng_state)."""
    L = ray["o"][0].shape[0]
    dev = ray["o"][0].device
    wavelengths = ray["wavelengths"]

    u_ch, rng_state = rng.next_float32(rng_state)
    channel = torch.clamp((u_ch * 4.0).to(torch.int32), max=3)

    hit = traverse.intersect(scene, ray["o"], ray["d"], ray["mint"], ray["maxt"])
    si = inter.compute_interaction(scene, hit, ray["o"], ray["d"], wavelengths,
                                   ray_diff=_ray_diff(ray))

    throughput = torch.ones((4, L), device=dev)
    result = torch.zeros((4, L), device=dev)
    eta = torch.ones((L,), device=dev)
    rad = emitter.radiance_all(scene, wavelengths)
    medium = torch.full((L,), -1, dtype=torch.int32, device=dev)  # the camera is in vacuum
    scattered = torch.zeros((L,), dtype=torch.bool, device=dev)
    null_chain = torch.ones((L,), dtype=torch.bool, device=dev)
    emitted_radiance = torch.ones((L,), dtype=torch.bool, device=dev)
    ray_o, ray_d = ray["o"], ray["d"]
    active = torch.ones((L,), dtype=torch.bool, device=dev)
    max_depth = scene.max_depth

    for idx in range(volpath_iters(scene, depth_cap)):
        with tracing.span(tracing.BOUNCE):
            depth = idx + 1

            # -------- draws (unconditional, fixed order) --------
            u_dist, rng_state = rng.next_float32(rng_state)
            u_nee, rng_state = rng.next_2d(rng_state)
            u_phase, rng_state = rng.next_2d(rng_state)
            u_bsdf1, rng_state = rng.next_float32(rng_state)
            u_bsdf2, rng_state = rng.next_2d(rng_state)
            u_rr, rng_state = rng.next_float32(rng_state)

            in_medium = medium >= 0
            mp = med.fetch_medium(scene, medium, wavelengths)
            ms = med.sample_distance(mp, channel, u_dist, si["t"], scene=scene, o=ray_o, d=ray_d,
                                     med_ids=medium)
            medium_scatter = active & in_medium & ms["scatter"]
            surface = active & ~medium_scatter

            # ======== medium interaction (volpath.cpp:44-74) ========
            # sigma_s at the scatter point is sigma_s * rho(x) (rho 1 in a
            # homogeneous medium), as the pdf holds rho
            tp_med = (throughput * (mp["sigma_s"] * ms["rho"][None, :]) * ms["tr"]
                      / torch.clamp(ms["pdf"], min=1e-30)[None, :])
            ms_p = vec.add(ray_o, vec.scale(ray_d, ms["t"]))
            # one emitter sample and one transmittance march for both branches,
            # from the scatter point or the surface
            ref_p = vec.where(medium_scatter, ms_p, si["p"])
            ds = emitter.sample_emitter_direct(scene, ref_p, wavelengths, u_nee, rad)
            tr_n = _attenuated_transmittance(scene, ref_p, ds["d"], ds["dist"], medium,
                                             wavelengths)
            ph_val = med.phase_eval(ray_d, ds["d"], mp["g"])
            contrib_m = tp_med * ds["spec"] * tr_n * ph_val[None, :]
            result = result + torch.where((medium_scatter & (ds["pdf"] > 0.0))[None, :],
                                          contrib_m, 0.0)
            # no phase sampling where the next depth passes max_depth
            # (volpath.cpp:56-57)
            med_continue = medium_scatter
            if max_depth > 0:
                med_continue = med_continue & (depth + 1 < max_depth)
            wo_phase, _, ph_w = med.phase_sample(ray_d, mp["g"], u_phase)
            tp_after_med = tp_med * ph_w[None, :]

            # ======== surface interaction (volpath.cpp:75-155) ========
            # the escape weight of lanes in a medium that reached the surface
            esc = ms["tr"] / torch.clamp(ms["pdf"], min=1e-30)[None, :]
            tp_surf = torch.where(in_medium[None, :], throughput * esc, throughput)
            show_emit = emitted_radiance & scattered if scene.hide_emitters else emitted_radiance
            # the environment on a miss (volpath.cpp:80-91)
            if scene.has_environment:
                env = emitter.eval_environment(scene, ray_d, wavelengths, rad)
                take_env = surface & ~si["valid"] & show_emit
                result = result + torch.where(take_env[None, :], tp_surf * env, 0.0)
            # an area emitter hit (volpath.cpp:93-97)
            em_val = emitter.eval_emitter(scene, si["emitter"], si["wi"], si["uv"], wavelengths,
                                          rad)
            take_em = surface & si["valid"] & (si["emitter"] >= 0) & show_emit
            result = result + torch.where(take_em[None, :], tp_surf * em_val, 0.0)

            # NEE from smooth BSDFs, attenuated, no MIS (volpath.cpp:99-112)
            p = bsdf.material_params(scene, si["bsdf"], si["uv"], wavelengths,
                                     duv=(si["duv_dx"], si["duv_dy"]))
            wo_nee = frame.to_local(si["sh"], ds["d"])
            f_nee = bsdf.eval_bsdf(p, si["wi"], wo_nee)
            take_nee = surface & si["valid"] & p["smooth"] & (ds["pdf"] > 0.0)
            result = result + torch.where(take_nee[None, :],
                                          tp_surf * ds["spec"] * tr_n * f_nee, 0.0)

            # BSDF sampling and the recursion's bookkeeping (volpath.cpp:114-155)
            bs = bsdf.sample_bsdf(p, si["wi"], u_bsdf1, u_bsdf2)
            wo_world = frame.to_world(si["sh"], bs["wo"])
            recursive = max_depth < 0 or depth + 1 < max_depth
            depth_ok = max_depth < 0 or depth < max_depth
            gather_direct = bs["delta"] & (~bs["null"] | null_chain)
            if not depth_ok:
                gather_direct = torch.zeros_like(gather_direct)
            new_emitted = gather_direct
            recursive = gather_direct | recursive
            new_null_chain = torch.where(gather_direct, True, null_chain & bs["null"])
            surf_continue = surface & si["valid"] & bs["valid"] & recursive
            tp_after_surf = tp_surf * bs["weight"]
            new_eta = torch.where(surf_continue, eta * bs["eta"], eta)
            new_medium_surf = inter.target_medium(si, wo_world, medium)
            new_scattered = scattered | (surface & ~bs["null"])

            # ======== merge the branches, then the next cast ========
            next_o = vec.where(medium_scatter, ms_p, si["p"])
            next_d = vec.where(medium_scatter, wo_phase, wo_world)
            throughput = torch.where(medium_scatter[None, :], tp_after_med, tp_after_surf)
            medium = torch.where(medium_scatter, medium, new_medium_surf)
            eta = torch.where(medium_scatter, eta, new_eta)
            scattered = medium_scatter | new_scattered
            null_chain = ~medium_scatter & new_null_chain
            emitted_radiance = ~medium_scatter & new_emitted
            active = (surface & surf_continue) | (medium_scatter & med_continue)
            active = active & (throughput.amax(dim=0) > 0.0)

            mint = inter.spawn_ray_mint(next_o)
            next_hit = traverse.intersect(scene, next_o, next_d, torch.where(active, mint, 0.0),
                                          torch.where(active, torch.inf, -1.0), coherent=False)
            si = inter.compute_interaction(scene, next_hit, next_o, next_d, wavelengths)

            # -------- Russian roulette (volpath.cpp:158-164) --------
            if depth + 1 >= scene.rr_depth:
                q = torch.clamp(throughput.amax(dim=0) * eta * eta, max=0.95).detach()
                active = active & ~(u_rr >= q)
                throughput = torch.where(active[None, :],
                                         throughput / torch.clamp(q, min=1e-8)[None, :],
                                         throughput)
            ray_o, ray_d = next_o, next_d

    return result, rng_state


def radiance(scene, ray, rng_state, integrator, depth_cap=DEFAULT_MAX_DEPTH_CAP):
    """The spectral radiance estimate of a radiance integrator, `path`,
    `direct` or `volpath`. `sppm` and `photonmapper` have no per-lane
    estimate (a visible point gathers a whole photon pass): they render
    through `render/ppm.py` `render_ppm`, which `driver.render` calls, and
    raise NotImplementedError here."""
    if integrator == "path":
        return sample_path(scene, ray, rng_state, depth_cap)
    if integrator == "direct":
        return sample_direct(scene, ray, rng_state)
    if integrator == "volpath":
        return sample_volpath(scene, ray, rng_state, depth_cap)
    if integrator in ("sppm", "photonmapper"):
        raise NotImplementedError(f"integrator '{integrator}' has no per-lane estimate: "
                                  "it renders through render.ppm.render_ppm")
    raise NotImplementedError(f"integrator '{integrator}'")
