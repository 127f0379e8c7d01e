"""`test_torch_train_dense.py`'s check for the other dense decoders:
gemma3_27b (local:global layers, the smoke window of 32 over 40 positions,
qk-norm, a tied head) with and without a logit soft cap of 50 (a config
override: no shipped config sets one, and the cap's backward runs only
then) and command_r_plus_104b (parallel attention and MLP off one
LayerNorm), in float, NPE-16 and NPE-8, with the gates stated there."""
import pytest

from _torch_train_common import check_decoder
from test_torch_train_dense import BASE_RTOL, LOSS_TOL, SEQ


@pytest.mark.parametrize("mode", ["float", "npe16", "npe8"])
@pytest.mark.parametrize("arch,over", [("gemma3_27b", {}),
                                       ("gemma3_27b", {"logit_softcap": 50.0}),
                                       ("command_r_plus_104b", {})],
                         ids=["gemma3_27b", "gemma3_27b-softcap50", "command_r_plus_104b"])
def test_local_and_parallel_decoders_match_reference(arch, over, mode):
    check_decoder(arch, mode, "float32", BASE_RTOL[mode], LOSS_TOL, SEQ,
                  ref_nudge=mode == "npe16", **over)
