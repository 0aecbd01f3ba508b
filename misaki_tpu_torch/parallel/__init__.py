"""Rendering and training over several processes (misaki_tpu/parallel)."""
