"""mfu.prefill: the prefills' roofline time (``cost.model.prefill``) over
their wall time, on the requests before the first profiler session."""
from portbench.cost import model
from portbench.harness.readings import step_share


def read(run):
    if run.kind != "prefill":
        return None
    return step_share(run, lambda it: model.prefill(run.cfg, it["tokens"]))
