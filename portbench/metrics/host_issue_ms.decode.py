"""host_issue_ms.decode: the host's time from a decode step's start to the
model's forward returning (every launch issued, before the token copy
waits for the device), averaged over the steps before the
first profiler session."""


def read(run):
    items = run.clean()
    if run.kind != "decode" or not items:
        return None
    return 1e3 * sum(it["issued"] - it["start"] for it in items) / len(items)
