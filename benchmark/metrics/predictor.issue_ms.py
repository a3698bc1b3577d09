"""predictor.issue_ms (ms): host time inside ``Predictor.run`` a call, over
every call of the closed loop's window (no synchronise inside)."""


def read(r):
    if not r.window["calls"]:
        return None
    return 1e3 * r.window["issue_s"] / r.window["calls"]
