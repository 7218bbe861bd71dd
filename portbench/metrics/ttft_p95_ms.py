"""ttft_p95_ms: 95th percentile over the window's requests of the time from
a prompt's submission to its first token on the host."""
from portbench.harness.readings import p95


def read(run):
    if run.kind != "prefill":
        return None
    return 1e3 * p95([it["done"] - it["start"] for it in run.items])
