"""prefill_tok_s: the prompt tokens of every request finished in the
window, over the window's seconds."""


def read(run):
    if run.kind != "prefill":
        return None
    return sum(it["tokens"] for it in run.items) / run.seconds
