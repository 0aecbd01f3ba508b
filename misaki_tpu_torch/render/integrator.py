"""Wavefront path integrator with NEE + MIS + Russian roulette
(reference: src/librender/integrators/path.cpp:19-141, driver loop
integrator.cpp:82-126), and the `direct`, `aov` and `debug` integrators'
per-wavefront estimates (direct.cpp, aov.cpp, debug.cpp).

The reference's per-ray recursion becomes a lockstep Python loop over
bounces on a lane-last SoA wavefront: every lane runs every stage under an
active mask. Each bounce makes one closest-hit cast and one shadow cast,
both through the cluster kernels (accel/cluster.py).

RNG discipline: every lane owns a PCG32 stream; draws happen unconditionally
in a fixed order per bounce (NEE 2D, BSDF 1D + 2D, RR 1D), so the sequence
is the same as `misaki_tpu.render.integrator` whatever the masking, device
or chunking.
"""

import torch

from misaki_tpu_torch.accel import traverse
from misaki_tpu_torch.bsdf import kernels as bsdf
from misaki_tpu_torch.core import frame, rng, vec
from misaki_tpu_torch.core import math as m
from misaki_tpu_torch.emitter import kernels as emitter
from misaki_tpu_torch.render import interaction as inter

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


def radiance(scene, ray, rng_state, integrator, depth_cap=DEFAULT_MAX_DEPTH_CAP):
    """The spectral radiance estimate of a radiance integrator, `path` or
    `direct`; the others raise NotImplementedError with their name."""
    if integrator == "path":
        return sample_path(scene, ray, rng_state, depth_cap)
    if integrator == "direct":
        return sample_direct(scene, ray, rng_state)
    raise NotImplementedError(f"integrator '{integrator}'")
