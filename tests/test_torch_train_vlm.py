"""`test_torch_train_dense.py`'s check for qwen2_vl_7b, whose batch puts 16
seeded patch embeddings (`embeds`) ahead of the tokens (M-RoPE over the
joined sequence; the loss drops the patches' logits, as the reference's
`launch/steps.py` does), in float, NPE-16 and NPE-8 at float32 compute;
and starcoder2_3b at bfloat16 compute, as `test_torch_train_bert_bf16.py`
runs BERT.  Gates as stated there; at bfloat16 the loss within 2e-4 and
BASE_RTOL 4e-2 in every mode: each bf16 rounding moves by a whole step
under the 1-ulp nudge, and the reference's own gradients change by up to
1.6 % under it (`test_torch_train_bert.py`)."""
import pytest

from _torch_train_common import check_decoder
from test_torch_train_dense import BASE_RTOL, LOSS_TOL, SEQ

BF16_RTOL, BF16_LOSS_TOL = 4e-2, 2e-4


@pytest.mark.parametrize("mode", ["float", "npe16", "npe8"])
def test_vlm_loss_and_grads_match_reference(mode):
    check_decoder("qwen2_vl_7b", mode, "float32", BASE_RTOL[mode], LOSS_TOL, SEQ,
                  ref_nudge=mode == "npe16")


@pytest.mark.parametrize("mode", ["float", "npe8"])
def test_bf16_decoder_loss_and_grads_match_reference(mode):
    check_decoder("starcoder2_3b", mode, "bfloat16", BF16_RTOL, BF16_LOSS_TOL, SEQ)
