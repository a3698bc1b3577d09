"""items_per_s (items/s): every item the closed loop completed over the
whole window, the host clock from the window's start to the end of the last
call's work on the card."""


def read(r):
    return r.window["calls"] * int(r.mix["batch"]) / r.window["wall_s"]
