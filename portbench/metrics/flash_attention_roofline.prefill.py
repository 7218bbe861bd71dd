"""flash_attention_roofline.prefill: whole-prompt attention in the traced
prefills, its roofline time (``cost.kernels.flash_attention``: S(S+1)/2
causal pairs at the bf16 peak) over its device time."""
from portbench.cost import kernels
from portbench.harness.readings import share_of_roofline


def read(run):
    if run.kind != "prefill":
        return None
    return share_of_roofline(run, "flash_attention", lambda it: kernels.
                             flash_attention(run.cfg, it["tokens"]))
