"""The port's training loss and gradients against the reference's for the
MoE and recurrent models: reduced grok-1-314b (the einsum dispatch, grok's
routing, the auxiliary loss over its groups), deepseek-v2-236b (MLA, the
gather dispatch, the dense layer 0 outside the groups), rwkv6-7b (the
chunked WKV scan) and zamba2-7b (the chunked SSD scan, the shared block
at two invocations, each with its own LoRA merged in), with f32 weights
on both sides; tolerances and batches as in
test_torch_train_grads.py (loss 1e-5 relative, every gradient leaf 1e-4 of
its largest |value|).
"""
import pytest

from test_torch_train_grads import F32_REL, check_loss_and_grads

ZOO_ARCHS = ("grok-1-314b", "deepseek-v2-236b", "rwkv6-7b", "zamba2-7b")


@pytest.mark.parametrize("arch", ZOO_ARCHS)
def test_loss_and_grads_match_reference_f32(arch):
    check_loss_and_grads(arch, True, F32_REL)
