"""The 95th percentile of the latencies of every request sent in the
window, each from its send to the moment the host saw its batch's device
work done (requests still in flight at the close are waited for)."""

import numpy as np


def read(run):
    lat = run.window.get("latencies_ms", ())
    return float(np.percentile(lat, 95)) if len(lat) else None
