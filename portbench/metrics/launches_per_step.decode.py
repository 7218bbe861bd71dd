"""launches_per_step.decode: device kernels a traced decode step launches
(copies and memsets left out)."""


def read(run):
    items = run.traced()
    if run.kind != "decode" or run.trace is None or not items:
        return None
    n = sum(1 for _, _, name in run.trace.kernels
            if not name.startswith(("Memcpy", "Memset")))
    return n / len(items)
