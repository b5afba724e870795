"""The scene generators, one module each, found by the name a
configuration gives under ``generator`` (``configs/<config>.json``).

A generator's module defines ``spheres(**args)``, which returns the
scene's (centre (N, 3), radius (N,), colour (N, 3)) float32 numpy arrays
from the configuration's ``generator.args``.  Each is a frozen copy of a
public suite's generator, so that neither the program nor a later change
to it decides what the benchmark renders.  A new kind of scene adds a
module here and changes none that is there.
"""
