"""Port parity of train mode: ``lm_loss`` and the gradient of every leaf
(repro_torch.models.transformer under torch.autograd) against
``jax.value_and_grad`` of the reference's ``lm_loss``, for one tiny config
of each family, from the reference's ``init_params(m2=False)`` carried over
by the bridge, on the reference pipeline's batch.

Tolerances (fp32 sums in another order): the loss within 1e-6 relative
(seen: 3.1e-7), every gradient leaf within 1e-4 x its largest magnitude
(seen: 2.4e-5, grok's router behind the softcap; 2.6e-6 elsewhere).
``remat`` (each layer recomputed in the backward pass) must give the same
gradients bit for bit."""
import pytest
import torch

from repro_torch.configs.base import get_config
from repro_torch.models import transformer as T
from repro_torch.tree import tree_leaves

from _torch_tiny import (check_gradients, check_remat, reference_grads,
                         dense_model)

#: the families held here (the others: tests/test_torch_trainer.py)
FIRST = ["dense", "parallel", "vlm", "moe", "hybrid"]


@pytest.fixture(scope="module", params=FIRST, ids=FIRST)
def family(request):
    return reference_grads(request.param)


def test_loss_and_every_gradient_match(family):
    check_gradients(family)


def test_remat_gives_the_same_gradients(family):
    check_remat(family)


def test_serving_modes_stay_without_grad():
    _, _, cfg, tp, batch = dense_model("qwen2.5-14b")
    for t in tree_leaves(tp):
        t.requires_grad_(True)
    cache = T.init_cache(cfg, 2, 20, device="cpu")
    logits, _, _ = T.forward(cfg, tp, torch.from_numpy(batch["tokens"]),
                             cache=cache, mode="prefill")
    assert not logits.requires_grad
    logits, _, _ = T.forward(cfg, tp, torch.from_numpy(batch["tokens"]))
    assert logits.requires_grad                       # mode "train"


@pytest.mark.parametrize("call", ["forward", "lm_loss"])
def test_window_override_is_not_ported(call):
    """The window override is ported but for the server's ``rows``, which
    raise on it (no path of the reference runs it there); a window wider
    than the sequence changes nothing (tests/test_torch_long_context.py
    holds narrower ones to the reference)."""
    cfg = get_config("qwen2.5-14b", tiny=True)
    params = T.init_params(cfg, device="cpu", m2=False)
    tokens = torch.zeros((1, 4), dtype=torch.int64)
    if call == "forward":
        with pytest.raises(NotImplementedError, match="window"):
            T.forward(cfg, params, tokens, window=8, rows=True)
        assert torch.equal(T.forward(cfg, params, tokens, window=8)[0],
                           T.forward(cfg, params, tokens)[0])
    else:
        assert torch.equal(
            T.lm_loss(cfg, params, {"tokens": tokens}, window=8)[0],
            T.lm_loss(cfg, params, {"tokens": tokens})[0])
