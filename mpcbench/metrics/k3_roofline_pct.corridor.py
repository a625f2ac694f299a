"""K3's share of its roofline in the corridor: the bound of the work the
window's cycles need (the configuration file's frozen count) over K3's
kernel time from the device trace, in %."""

from mpcbench import peaks


def read(run):
    if run["driver"] != "closed_loop":
        return None
    return peaks.k3_roofline_pct(run)
