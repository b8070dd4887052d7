"""Device-busy ms a train step of the traced stretch: the union of the
device's operation intervals over the profiled steps. The host paces the
step, so the window's rate and period follow the host's speed; this is the
device's own share of a step, which a change to the kernels moves whatever
the host does."""


def read(info):
    if info.trace is None or info.trace.busy_s <= 0:
        return None
    return 1e3 * info.trace.busy_s / info.steps
