"""The plain reference that decides `correct`, written for the benchmark
and independent of the program: it imports nothing of it and shares with it
only what a sample-for-sample comparison needs both sides to agree on, the
scene XML, the PCG32 streams (`pcg32.py`) and the CIE tables (`cie.py`).

- `scene.py`: the XML read, the Cornell box's quads, sRGB colours lifted to
  sigmoid spectra by a Newton solve, the camera's frame;
- `path.py`: pinhole rays, every ray cast against every triangle, the path
  tracer with light sampling, MIS and roulette, the gaussian film, the image
  loss's gradient by autograd;
- `sppm.py`: photon mapping with a grid gather;
- `precision.py`: the matrix products, in float32 or, for the control, TF32.
"""
