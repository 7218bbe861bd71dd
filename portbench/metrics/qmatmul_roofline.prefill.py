"""qmatmul_roofline.prefill: the sparse FFN's qmatmul kernels in the traced
prefills, their roofline time (``cost.kernels.qmatmul_ffn`` at M = the
prompt's tokens) over their device time."""
from portbench.cost import kernels
from portbench.harness.readings import share_of_roofline


def read(run):
    if run.kind != "prefill":
        return None
    return share_of_roofline(run, "qmatmul", lambda it: kernels.qmatmul_ffn(
        run.cfg, it["tokens"]))
