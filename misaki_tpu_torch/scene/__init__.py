"""Scene loading, compilation and the scene tables."""

import numpy as np

from misaki_tpu_torch.scene.types import (
    Camera,
    CompiledScene,
    EmitterTable,
    Geometry,
    MaterialTable,
)


def from_compiled(arrays, device="cpu"):
    """The port's scene from a `misaki_tpu` CompiledScene whose leaves are
    numpy arrays (`jax.tree_util.tree_map(np.asarray, scene)`), so both
    packages compute on the very same tables. The cluster accel is built
    here from the first `n_faces` geometry columns, since the JAX scene holds
    none for small scenes. Takes the object by duck typing: this package
    never imports the JAX one."""
    from misaki_tpu_torch.scene.compiler import cluster_from_geometry

    if len(getattr(arrays, "bitmap_meta", ())):
        raise NotImplementedError("bitmap texture")
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
    )
    return scene.to(device)
