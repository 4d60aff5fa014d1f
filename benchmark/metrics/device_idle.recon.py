"""Share of the traced window, in %, in which no operation ran on the device."""


def read(t):
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
