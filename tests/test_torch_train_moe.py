"""The MoE decoders' training forward and backward against the reference's:
the loss and every gradient of the smoke granite_moe_1b_a400m (MoE every
layer, a softmax router, top-2 of 4 experts, a tied head) and
llama4_maverick_400b_a17b (interleave 2: a dense layer, then an MoE one
with a sigmoid router, top-1 of 4, and a shared expert) against
`jax.value_and_grad`, run op by op, on the same float32 masters and a
(2, 40) batch, in float, NPE-16 and NPE-8 at float32 compute, with the
gates of `test_torch_train_dense.py` (`_torch_train_common.check_decoder`).

The gradient reaches each router through the gates of the kept choices:
the stable top-k sort (jax.lax.top_k's lower index first among ties), the
renormalization over the selected k (softmax) and the router function (the
NVU softmax's backward kernel, or the sigmoid table's slope, in NPE mode).
A choice that capacity drops passes no gradient, as the reference's
one-hot dispatch passes none.  Capacity is max(1, int(40 k / 4 * 1.25))
slots an expert a sequence (25 for top-2, 12 for top-1); each batch here
drops choices in every MoE layer, which the test asserts, and every
router's gradient is compared leaf by leaf with the rest; in float and
NPE-16 it is nonzero.  (In NPE-8 the head's MMU passes gradient only to the
entry that sets its per-tensor activation scale, so only a few tokens carry
any back to the routers; llama4's one router gets none on this batch, in
the reference as in the port.)
"""
import numpy as np
import pytest

from _torch_train_common import check_decoder
from repro_torch.models import moe
from test_torch_train_dense import BASE_RTOL, LOSS_TOL, SEQ


class Drops:
    """Count, for each call of `moe.route`, the choices capacity drops."""

    def __enter__(self):
        self.route, self.dropped = moe.route, []

        def counting(cfg, p, x):
            r = self.route(cfg, p, x)
            self.dropped.append(int((~r.kept).sum()))
            return r

        moe.route = counting
        return self

    def __exit__(self, *exc):
        moe.route = self.route


@pytest.mark.parametrize("mode", ["float", "npe16", "npe8"])
@pytest.mark.parametrize("arch", ["granite_moe_1b_a400m", "llama4_maverick_400b_a17b"])
def test_moe_decoder_loss_and_grads_match_reference(arch, mode):
    with Drops() as drops:
        got, _ = check_decoder(arch, mode, "float32", BASE_RTOL[mode], LOSS_TOL, SEQ,
                               ref_nudge=mode == "npe16")
    layers = 2 if arch.startswith("granite") else 1
    # the port's runs route every MoE layer: twice with remat (the forward,
    # then again in the backward pass), once in each nudged run; every call
    # dropped some choice
    assert len(drops.dropped) == layers * 4
    assert all(n > 0 for n in drops.dropped), drops.dropped
    routers = {n: g for n, g in got.items() if n.endswith("moe.router")}
    assert len(routers) == layers
    if mode != "npe8":
        assert all(np.abs(g).max() > 0 for g in routers.values())
