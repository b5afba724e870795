"""The drivers of the traffic mixes, one module each, found by the name a
mix gives under ``driver`` (``traffic/<mix>.json``).

A driver's module defines ``Driver(config, mix, seed, device)``, which
draws its inputs from the seed with the mix's parameters and sets the
program up, and has:

* ``run(i)``: submits unit i and returns its outputs without waiting;
* ``wait()``: waits until what was submitted is done (the harness calls
  it after each unit; it is where a mix sets its own sync policy);
* ``inputs(i)``: what the reference is handed for unit i;
* ``release()``: drops the program's state before the check;
* ``reference(i, dtype)``: the reference's outputs of unit i, in the
  program's form, computed in ``dtype``, with the work it counted;
* ``compare(out, ref, info)``: the numbers of ``check.py``.

A mix that reuses a driver is data alone; a new kind of unit adds a
module here and changes none that is there.
"""
