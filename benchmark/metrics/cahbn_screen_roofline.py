"""Share of its roofline that screen kernel B reaches in the window: the
sum over its launches of the least time the card could take (operations
and bytes from each launch's arguments, ``counts.screens``, against
the float32 and HBM peaks) over the device time of the kernels those
launches run, ``cahbn_screen*`` and the ``mean_error_kernel`` of the same
calls. None where no such launch ran or the trace holds none."""

NAME = "cahbn_screen_roofline"
UNIT = "%"
LAYER = "screen kernel B"
MOVES = "experiment_s"
KERNEL = "cahbn"
NAMES = ("cahbn_screen", "mean_error_kernel")


def read(run):
    bound_ms = sum(s["bound_ms"] for s in run["screens"] if s["kernel"] == KERNEL)
    trace = run["trace"]
    if not bound_ms or trace is None:
        return None
    device_ns = sum(b - a for name, a, b in trace.ops if any(n in name for n in NAMES))
    return 100.0 * bound_ms * 1e6 / device_ns if device_ns else None
