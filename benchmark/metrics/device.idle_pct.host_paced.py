"""device.idle_pct.host_paced (device_trace): ``device.idle_pct`` in the
cells whose pace the host sets, where it moves ``rows_per_s.host_paced``."""

import harness

_base = harness.load("metrics", "device.idle_pct")
read = _base.read
if hasattr(_base, "start"):
    start = _base.start
