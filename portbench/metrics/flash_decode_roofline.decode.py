"""flash_decode_roofline.decode: flash_decode in the traced decode steps,
its roofline time (``cost.kernels.flash_decode``: each row's valid K/V
slots, q and the output, at the memory rate) over its device time."""
from portbench.cost import kernels
from portbench.harness.readings import share_of_roofline


def read(run):
    if run.kind != "decode":
        return None
    return share_of_roofline(run, "flash_decode", lambda it: kernels.
                             flash_decode(run.cfg, [it["pos"] + 1] *
                                          it["rows"]))
