"""qmatmul_roofline.decode: the sparse FFN's qmatmul kernels in the traced
decode steps, their roofline time (``cost.kernels.qmatmul_ffn`` at M =
the batch's rows, a layer a call) over their device time."""
from portbench.cost import kernels
from portbench.harness.readings import share_of_roofline


def read(run):
    if run.kind != "decode":
        return None
    return share_of_roofline(run, "qmatmul", lambda it: kernels.qmatmul_ffn(
        run.cfg, it["rows"]))
