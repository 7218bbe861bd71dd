"""mfu.decode: the decode steps' roofline time (``cost.model.decode_step``:
the larger of their operations at the bf16 peak and their bytes at the
memory rate) over their wall time, on the steps before the first profiler session."""
from portbench.cost import model
from portbench.harness.readings import step_share


def read(run):
    if run.kind != "decode":
        return None
    return step_share(run, lambda it: model.decode_step(
        run.cfg, [it["pos"]] * it["rows"]))
