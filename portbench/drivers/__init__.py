"""Drivers: each feeds one kind of traffic to one public entry point of the
port. A driver module defines ``Driver(ctx)``, whose constructor is the
set-up (weights, inputs, warm-up of this traffic's shapes) and whose
methods are:

* ``unit() -> int``: one call, clip or step of the window; returns the
  useful frames or samples it did;
* ``sync()``: wait for the device (the window closes after it);
* ``end_to_end(window_s, useful) -> dict``: the cell's end-to-end metrics
  but ``setup_s``;
* ``work() -> dict``: the counts the per-layer readers use;
* ``release()``: free the program's state once the window has closed;
* ``numbers() -> dict``: the numbers compared with the cell's limits;
* ``control_numbers() -> dict``: the same numbers for the control
  (the reference in a lower precision in the program's place).
"""
