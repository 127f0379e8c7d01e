"""The dense decoders' training forward and backward against the
reference's: the loss and every gradient of the smoke glm4_9b (pre-norm,
RoPE, qkv bias, RMSNorm, SwiGLU) and starcoder2_3b (LayerNorm with beta,
GELU, sliding window 32) against `jax.value_and_grad` of `registry.apply` +
`cross_entropy`, run op by op, on the same float32 masters (the
reference's `init_params` through `models/convert.masters_from_jax`) and
the same (2, 40) batch, in float, NPE-16 and NPE-8 at float32 compute.  40
positions pass the smoke window of 32, so the window hides keys.  The port
runs with remat, its attention through the dense mode's autograd Function
(`kernels/ops.DenseAttentionFn`, whose CPU backward is
`dense_attention_grad_plain`).

Gates (`_torch_train_common.check_decoder` and `compare_grads`):
  * the loss within 1e-5 (float32 sums in other orders); in the NPE modes
    within twice the port's own change when every master moves up one
    float32 ulp, where that is larger (an int8 or int16 rounding that goes
    the other way moves it by a whole step);
  * each gradient leaf within BASE_RTOL of its largest value, or within
    twice the port's own change when every master moves one float32 ulp up
    or down, where that is larger, plus 1e-6 of the model's largest
    gradient.  BASE_RTOL: float 1e-4 (the reference's own 1-ulp nudges
    move its float32 gradients by up to 2.4e-6 of a leaf's largest value,
    glm4_9b; the port's by as much);
    NPE-8 1e-4 and the nudge rule, with the same nonzero gradient entries
    (its MMU passes gradient through the scales alone); NPE-16 5e-3, the
    reference's NPE-mode gate, where the nudge rule also takes the
    reference's own change under both nudges: its NPE-16 gradients move by
    up to 4 % of a leaf's largest value under them (gemma3's layers.1.wq,
    qwen2_vl's layers.1.mlp.wg 2.8 %), where the port's nudges move it by
    1 %, since a pre-activation next to a PWL knot or an int16 rounding
    boundary moves to the other side in one package and not in the other
    (llama4's expert 1, hidden unit 59: 2 % of layers.1.moe.wg).
`test_torch_train_dense_local.py` holds gemma3_27b and command_r_plus_104b,
`test_torch_train_vlm.py` qwen2_vl_7b and a bfloat16 case, and
`test_torch_train_moe.py` the MoE decoders: the reference op by op compiles
each op once a process, so each file pays that once.
"""
import pytest

from _torch_train_common import check_decoder

BASE_RTOL = {"float": 1e-4, "npe16": 5e-3, "npe8": 1e-4}
LOSS_TOL = 1e-5
SEQ = 40


@pytest.mark.parametrize("mode", ["float", "npe16", "npe8"])
@pytest.mark.parametrize("arch", ["glm4_9b", "starcoder2_3b"])
def test_dense_decoder_loss_and_grads_match_reference(arch, mode):
    check_decoder(arch, mode, "float32", BASE_RTOL[mode], LOSS_TOL, SEQ,
                  ref_nudge=mode == "npe16")
