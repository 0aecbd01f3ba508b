"""The yardstick's constants and work counts, frozen here so that no later
change to the port moves them.

Peak: NVIDIA's H100 SXM data sheet (HBM3 bandwidth, at the 700 W power
limit). Rays: `rays_per_sample` of misaki_tpu_torch/tools/bench.py for the
path integrator. Cast bytes: each input read once and each output written
once, as PERF.md's kernel table counts them for csrc/cluster.cu.
"""

HBM_BYTES_PER_S = 3.35e12

# the ray (o, d, mint, maxt), the hit (t, u, v, id), the winner's face row
CLOSEST_RAY_BYTES = 32 + 16 + 144
ANYHIT_RAY_BYTES = 32 + 4           # the ray, the occlusion flag
FACE_BYTES = 48                     # a face's row of the leaf table (p0, e1, e2, id: 12 floats)

CLOSEST_KERNELS = ("closest_hit_kernel",)
ANYHIT_KERNELS = ("any_hit_kernel",)
DENSITY_KERNEL_PREFIX = "density_"


def bounce_iters(config, depth_cap):
    """NEE + BSDF iterations of the path integrator: max_depth - 1 where it
    is set, else the depth cap (render/integrator.py n_bounce_iters)."""
    d = int(config["max_depth"])
    return d - 1 if d > 0 else int(depth_cap)


def rays_per_sample(config, depth_cap):
    """The camera ray and two rays per bounce iteration (a closest hit, a
    shadow ray), whether or not the lane is still alive."""
    return 1 + 2 * bounce_iters(config, depth_cap)


def cast_bytes_per_frame(config, traffic):
    """The least bytes a path frame's casts must move: its closest-hit rays
    (the camera's and one a bounce iteration) and shadow rays at the bytes
    above, and the face table once a launch (chunks x casts a chunk)."""
    samples = int(config["width"]) * int(config["height"]) * int(config["spp"])
    iters = bounce_iters(config, traffic["depth_cap"])
    closest = 1 + iters
    shadow = rays_per_sample(config, traffic["depth_cap"]) - closest
    chunk = 1 << int(traffic["chunk_log2"])
    chunk = max(int(config["spp"]), chunk // int(config["spp"]) * int(config["spp"]))
    chunks = -(-samples // chunk)
    launches = chunks * (closest + shadow)
    return (samples * (closest * CLOSEST_RAY_BYTES + shadow * ANYHIT_RAY_BYTES)
            + launches * int(config["faces"]) * FACE_BYTES)
