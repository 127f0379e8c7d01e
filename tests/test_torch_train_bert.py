"""The port's BERT training forward and backward against the reference's:
the loss and every gradient of the 2-layer smoke `bert_base` (D=128, 4
heads over 2 kv heads, V=512) against `jax.value_and_grad` of
`registry.apply` + `cross_entropy`, run op by op, on the same float32
masters (the reference's `init_params`, `models/convert.masters_from_jax`)
and the same (2, 32) batch, in float, NPE-16 and NPE-8, at float32 compute
(`test_torch_train_bert_bf16.py`: bfloat16; two files, since the reference
op by op takes about 40 s a file).  The port runs with remat (each layer under
`torch.utils.checkpoint`), the reference without (the values are the
same).

Gates (`_torch_train_common.compare_grads`):
  * the loss: 1e-5 in float32 (sums in other orders), 2e-4 in bfloat16;
  * each gradient leaf: within BASE_RTOL of its largest value, or within
    twice the port's own change when every master moves by one float32
    ulp, where that is larger, plus 1e-6 (float32) or 1e-4 (bfloat16) of
    the model's largest gradient.  BASE_RTOL is 1e-4 for float and NPE-8 in
    float32, and 4e-2 for NPE-16 and for bfloat16: NPE-16's fake
    quantization and every bf16 rounding move by a whole step under such a
    nudge, and the reference's own gradients change by up to 1.6 % under it
    (NPE-16 float32, float bfloat16), so 4e-2 is about twice that;
  * NPE-8: the same set of nonzero gradient entries (its MMU passes
    gradient only through the scales, to the entries that set them: about
    1 % of the parameters are nonzero).
"""
import numpy as np
import pytest

from _torch_train_common import (batch, compare_grads, configs, port_value_and_grad,
                                 ref_params, ref_value_and_grad)

BASE_RTOL = {("float", "float32"): 1e-4, ("npe8", "float32"): 1e-4,
             ("npe16", "float32"): 4e-2, ("float", "bfloat16"): 4e-2,
             ("npe16", "bfloat16"): 4e-2, ("npe8", "bfloat16"): 4e-2}
LOSS_TOL = {"float32": 1e-5, "bfloat16": 2e-4}
DTYPE = "float32"       # test_torch_train_bert_bf16.py runs the same at bfloat16


def check_mode(mode, dtype):
    rc, pc = configs(mode, dtype)
    tree = ref_params(rc)
    tokens, labels = batch()
    want_loss, want = ref_value_and_grad(rc, tree, tokens, labels)
    got_loss, got = port_value_and_grad(pc, tree, tokens, labels)
    _, noise = port_value_and_grad(pc, tree, tokens, labels, nudge=True)
    assert abs(got_loss - want_loss) <= LOSS_TOL[dtype], (got_loss, want_loss)
    compare_grads(pc, want, got, BASE_RTOL[(mode, dtype)], noise=noise,
                  same_nonzero=mode == "npe8")
    if mode == "npe8":
        nonzero = sum(int(np.count_nonzero(g)) for g in got.values())
        assert nonzero < 0.05 * sum(g.size for g in got.values())


@pytest.mark.parametrize("mode", ["float", "npe16", "npe8"])
def test_bert_loss_and_grads_match_reference(mode):
    check_mode(mode, DTYPE)
