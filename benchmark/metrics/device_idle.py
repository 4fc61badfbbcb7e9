"""Share of the traced window in which no operation ran on the device:
one minus the union of the device operations' intervals over the
window's length."""

NAME = "device_idle"
UNIT = "%"
LAYER = "device"
MOVES = "experiment_s"


def read(run):
    trace = run["trace"]
    if trace is None or not trace.ops or trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - trace.busy_s / trace.window_s)
