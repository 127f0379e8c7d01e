"""`test_torch_train_bert.py`'s check at bfloat16 compute: the loss and
every gradient of the smoke BERT against the reference's `jax.value_and_grad`,
run op by op, in float, NPE-16 and NPE-8, with the gates stated there."""
import pytest

from test_torch_train_bert import check_mode


@pytest.mark.parametrize("mode", ["float", "npe16", "npe8"])
def test_bert_bf16_loss_and_grads_match_reference(mode):
    check_mode(mode, "bfloat16")
