"""K3's share of its roofline in the fleet: the bound of the window's warm
robot solves (the configuration file's frozen count) over K3's kernel time
from the device trace, in %."""

from mpcbench import peaks


def read(run):
    if run["driver"] != "fleet":
        return None
    return peaks.k3_roofline_pct(run)
