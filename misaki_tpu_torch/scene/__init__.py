"""Scene loading, compilation and the scene tables."""

import numpy as np

from misaki_tpu_torch.scene.types import (
    bitmap_level_table,
    Camera,
    CompiledScene,
    EmitterTable,
    Geometry,
    MaterialTable,
    MediumTable,
)


def from_compiled(arrays, device="cuda"):
    """The port's scene from a `misaki_tpu` CompiledScene whose leaves are
    numpy arrays (`jax.tree_util.tree_map(np.asarray, scene)`), so both
    packages compute on the very same tables. The tables lie on `device`:
    the card unless the caller asks for the CPU, and without a CUDA device
    that raises (as `compile_scene` does). The cluster accel is built
    here from the first `n_faces` geometry columns, since the JAX scene holds
    none for small scenes. The env and bitmap tables are taken flat (the
    bitmap atlas transposed to texel-major), never from the JAX pages; the
    (1, Npad) volume row becomes the flat (Npad,) table.
    Takes the object by duck typing: this package never imports the JAX
    one."""
    from misaki_tpu_torch.scene.compiler import cluster_from_geometry, target_device

    device = target_device(device, "from_compiled")
    g, em, cam = arrays.geometry, arrays.emitters, arrays.camera

    def a(x, dtype=None):
        return np.array(x, dtype=dtype)

    geom = Geometry(p0=a(g.p0), e1=a(g.e1), e2=a(g.e2), face_tab=a(g.face_tab))
    emitters = EmitterTable(
        kind=a(em.kind, np.int32), shape=a(em.shape, np.int32),
        rad_coeff=a(em.rad_coeff), rad_curve=a(em.rad_curve), position=a(em.position),
        face_global=a(em.face_global, np.int32), face_cdf=a(em.face_cdf),
        face_pack=a(em.face_pack), area=a(em.area),
        bsphere_center=a(em.bsphere_center), bsphere_radius=np.float32(em.bsphere_radius),
        env_rgb=a(em.env_rgb, np.float32), env_pmf=a(em.env_pmf, np.float32),
        env_marg_cdf=a(em.env_marg_cdf, np.float32),
        env_cond_cdf=a(em.env_cond_cdf, np.float32),
        env_to_world=a(em.env_to_world, np.float32),
        env_to_local=a(em.env_to_local, np.float32),
    )
    med = arrays.media
    media = MediumTable(
        kind=a(med.kind, np.int32), sigma_s=a(med.sigma_s, np.float32),
        sigma_a=a(med.sigma_a, np.float32), sigma_s_coeff=a(med.sigma_s_coeff, np.float32),
        sigma_a_coeff=a(med.sigma_a_coeff, np.float32),
        sigma_s_amp=a(med.sigma_s_amp, np.float32), sigma_a_amp=a(med.sigma_a_amp, np.float32),
        scale=a(med.scale, np.float32), g=a(med.g, np.float32),
        density_vol=a(med.density_vol, np.int32),
    )
    scene = CompiledScene(
        geometry=geom,
        cluster=cluster_from_geometry(geom, arrays.n_faces),
        materials=MaterialTable(params=a(arrays.materials.params)),
        emitters=emitters,
        camera=Camera(to_world=a(cam.to_world), sample_to_camera=a(cam.sample_to_camera),
                      near=np.float32(cam.near), far=np.float32(cam.far)),
        shape_bsdf=a(arrays.shape_bsdf, np.int32),
        shape_emitter=a(arrays.shape_emitter, np.int32),
        film_width=arrays.film_width, film_height=arrays.film_height, spp=arrays.spp,
        max_depth=arrays.max_depth, rr_depth=arrays.rr_depth,
        hide_emitters=arrays.hide_emitters, integrator=arrays.integrator,
        filter_type=arrays.filter_type, filter_stddev=arrays.filter_stddev,
        film_format=arrays.film_format, n_faces=arrays.n_faces,
        n_shapes=arrays.n_shapes, n_emitters=arrays.n_emitters,
        has_environment=arrays.has_environment, environment_idx=arrays.environment_idx,
        emitter_kinds=tuple(arrays.emitter_kinds), bsdf_kinds=tuple(arrays.bsdf_kinds),
        crop_x=arrays.crop_x, crop_y=arrays.crop_y,
        bitmaps=np.ascontiguousarray(a(arrays.bitmaps, np.float32).T),
        bitmap_meta=tuple(arrays.bitmap_meta), bitmap_slots=tuple(arrays.bitmap_slots),
        bitmap_levels=bitmap_level_table(arrays.bitmap_meta),
        aovs=tuple(arrays.aovs), aov_nested=arrays.aov_nested,
        direct_light_samples=arrays.direct_light_samples,
        direct_bsdf_samples=arrays.direct_bsdf_samples,
        ppm_photons=arrays.ppm_photons, ppm_iterations=arrays.ppm_iterations,
        ppm_radius=arrays.ppm_radius,
        diff_mode=bool(getattr(arrays, "diff_mode", False)),
        media=media, volumes=a(arrays.volumes, np.float32).reshape(-1),
        volume_meta=tuple(arrays.volume_meta),
    )
    return scene.to(device)


def leaves_from_jax(values):
    """`misaki_tpu` parameter leaves {name: numpy array}, in its layout,
    -> the same values in the port's layout (numpy): every leaf as it is but
    `bitmaps`, whose (3, Npad) atlas becomes the texel-major (Npad, 3)
    table, and `volumes`, whose (1, Npad) row becomes the flat (Npad,)
    table, as `from_compiled` takes them."""
    def port(k, v):
        if k == "bitmaps":
            return np.ascontiguousarray(np.asarray(v, np.float32).T)
        if k == "volumes":
            return np.asarray(v, np.float32).reshape(-1)
        return np.asarray(v)

    return {k: port(k, v) for k, v in values.items()}


def grads_to_jax(grads):
    """The port's leaf gradients {name: tensor} -> numpy arrays in
    `misaki_tpu`'s layout (the inverse of `leaves_from_jax`)."""
    def jax_layout(k, g):
        if k == "bitmaps":
            return np.ascontiguousarray(g.T)
        if k == "volumes":
            return g.reshape(1, -1)
        return g

    return {k: jax_layout(k, g.detach().cpu().numpy()) for k, g in grads.items()}
