"""idle_share.prefill: share of the traced prefills' stretch with no
operation on the device."""
from portbench.harness.readings import idle_share


def read(run):
    return idle_share(run) if run.kind == "prefill" else None
