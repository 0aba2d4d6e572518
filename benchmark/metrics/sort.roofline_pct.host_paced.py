"""sort.roofline_pct.host_paced (device_trace): ``sort.roofline_pct`` in the
cells whose pace the host sets, where it moves ``rows_per_s.host_paced``."""

import harness

_base = harness.load("metrics", "sort.roofline_pct")
read = _base.read
if hasattr(_base, "start"):
    start = _base.start
