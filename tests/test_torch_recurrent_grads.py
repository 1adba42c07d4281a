"""Autograd through the port's recurrent families (mamba2's SSD scan and
causal convolutions, recurrentgemma's RG-LRU doubling scan and local
attention) against ``jax.grad``, as ``test_torch_grads.py`` does for the
attention families, with its tolerances."""
import pytest

from test_torch_grads import check_grads_match_jax


@pytest.mark.parametrize("arch", ["mamba2-780m", "recurrentgemma-2b"])
def test_grads_match_jax_grad(arch):
    check_grads_match_jax(arch)
