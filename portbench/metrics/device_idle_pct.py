"""device_idle_pct (device; moves qps): the share of the traced calls'
host window, from the first call's start to the last call's end, in which
no device activity ran (1 − the union of the device's spans over that
window)."""


def read(run):
    tr = run.trace
    if tr is None or not tr.device or tr.window_s <= 0:
        return None
    return 100.0 * (1.0 - tr.busy_s() / tr.window_s)
