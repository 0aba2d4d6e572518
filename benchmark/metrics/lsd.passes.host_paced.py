"""lsd.passes.host_paced (program_counter): ``lsd.passes`` in the cells whose
pace the host sets, where it moves ``rows_per_s.host_paced``."""

import harness

_base = harness.load("metrics", "lsd.passes")
read = _base.read
if hasattr(_base, "start"):
    start = _base.start
