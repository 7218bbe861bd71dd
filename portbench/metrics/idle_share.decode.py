"""idle_share.decode: share of an untraced decode step with no operation on
the device: 1 - the device's busy time a step in the device session over
the host's wall time a step before any profiler session. Tracing leaves
the kernels' times as they are but costs the host a few microseconds a
launch, and a decode step is paced by the host's launches, so the traced
stretch's own idle share reads higher than an untraced step's."""


def read(run):
    if run.kind != "decode" or run.trace is None:
        return None
    traced, clean = run.traced(), run.clean()
    if not traced or len(clean) < 2:
        return None
    busy = run.trace.busy_s / len(traced)
    wall = (clean[-1]["done"] - clean[0]["start"]) / len(clean)
    return 100.0 * (1.0 - busy / wall)
