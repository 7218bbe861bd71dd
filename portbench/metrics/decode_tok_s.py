"""decode_tok_s: every token that reached the host in the window, over the
window's seconds."""


def read(run):
    if run.kind != "decode":
        return None
    return sum(it["rows"] for it in run.items) / run.seconds
