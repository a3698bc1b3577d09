"""device.idle_share.offline (%): the share of the traced stretch in which
no kernel, copy or set ran on the card (1 - the union of their intervals
over the stretch), in the offline cells."""


def read(r):
    if r.trace is None:
        return None
    return 100.0 * (1.0 - r.trace["busy_s"] / r.trace["window_s"])
