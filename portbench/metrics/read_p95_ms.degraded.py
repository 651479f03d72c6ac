"""read_p95_ms.degraded (ms): the 95th percentile of the wall time of
every read that finished in the window (``read_needle`` from call to
return, on its client's thread)."""

import numpy as np


def read(outcome):
    lat = outcome.readings.get("latencies_s")
    if not lat:
        return None
    return 1e3 * float(np.percentile(lat, 95))
