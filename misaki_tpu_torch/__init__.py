"""misaki_tpu_torch — the spectral path tracer of `misaki_tpu`, ported to
PyTorch and hand-written CUDA kernels for an NVIDIA H100.

The package mirrors `misaki_tpu`'s layout (core/, scene/, accel/, bsdf/,
emitter/, render/) and is held against it, function by function, by
tests/test_torch_*.py. It imports torch and numpy, never jax.

    python -m misaki_tpu_torch.cli misaki_tpu_torch/scenes/cbox/scene.xml \\
        -o cbox.png --device cuda
"""


def __getattr__(name):
    # lazy, as misaki_tpu/__init__.py:31-41: `import misaki_tpu_torch.core.*`
    # pays for no scene code. No lazy `render`: it would shadow the render/
    # subpackage once that is imported.
    if name in ("load_file", "load_string"):
        from misaki_tpu_torch.scene import loader

        return getattr(loader, name)
    raise AttributeError(name)
