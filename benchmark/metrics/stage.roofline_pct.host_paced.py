"""stage.roofline_pct.host_paced (device_trace): ``stage.roofline_pct`` in
the cells whose pace the host sets, where it moves
``rows_per_s.host_paced``."""

import harness

_base = harness.load("metrics", "stage.roofline_pct")
read = _base.read
if hasattr(_base, "start"):
    start = _base.start
