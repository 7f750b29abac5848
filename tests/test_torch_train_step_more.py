"""`tests/test_torch_train_step.py`'s checks for the archs with a memory
stream or a longer period: whisper (encoder-decoder), llama-3.2-vision
(cross-attention every 5 layers) and grok-1 (8-expert MoE)."""
import pytest

from test_torch_train_step import (check_gradients, check_params, check_steps, port_steps,  # noqa: F401
                                   reference_run, two_torch_threads)

ARCHS = ["whisper-large-v3", "llama-3.2-vision-11b", "grok-1-314b"]


@pytest.fixture(scope="module", params=ARCHS)
def ref(request):
    return reference_run(request.param)


def test_apply_train_gradients_match_reference(ref):
    check_gradients(ref)


def test_train_steps_match_reference(ref):
    steps, final = port_steps(ref)
    check_steps(ref, steps)
    check_params(ref, final)
