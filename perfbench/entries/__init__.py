"""The program's paths that a cell can drive, one module each, found by name.

A traffic mix names its entry (``"entry"``; ``pipeline`` where it names
none), and ``entries/<entry>.py`` holds everything of that path:

* ``NAMES``: the numbers its judge compares, each with its limit in
  ``limits/<config>.json``; ``MAXED`` and ``SUMMED``: the counts that
  ``judge_call`` gives beside them, combined over calls by max or by sum;
* ``build(cell, root, made, device)``: the program under test, from what the
  configuration's builder ``made``: a callable that takes one chunk of the
  pool and returns the call's outputs (tensors, which the harness copies to
  the host, or host arrays);
* ``reference(cell, pool, made, device, root, tf32=False)``: the plain
  reference of the same semantics on every chunk, computed with nothing of
  the program (``tf32`` for the control);
* ``judge_call(cell, arrays, refs, k)``: one call's outputs, as numpy,
  against the reference's on chunk ``k``;
* ``keep(program)``: what ``notes`` reports of the program's state, taken
  before the program is freed;
* ``notes(got, kept, refs)``: lines for standard error about what was judged;
* ``faults(cell, s, outs)``: the outputs of one call per chunk with each
  fault that the path can have planted (``readings.py``);
* ``control_outputs(refs)``: the reference's results in the program's output
  layout, per chunk (the control, ``readings.py``);
* ``golden(cell, s, root)``: an informational check, or None.

A traced run reads the stages from the program's own spans
(``df3d.*``, ``progspans.py``): an entry names none.  Entry modules, and
no other module of the benchmark, may import the program,
``deepfly3d_torch``, and only inside their functions.
"""

from __future__ import annotations

import os

import named

DIR = os.path.dirname(os.path.abspath(__file__))
DEFAULT = "pipeline"


def of(mix: dict):
    """The entry module that a traffic mix names."""
    return named.load(DIR, mix.get("entry", DEFAULT))
