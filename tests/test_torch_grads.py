"""Gradients of the port's ``loss_fn`` (autograd through
``repro_torch.models``) against ``jax.value_and_grad(repro.models.loss_fn)``
at the 10 smoke configs, in fp32 on the CPU, from the reference's weights:
each gradient within 1e-5 of its reference leaf's largest |gradient|, the
loss within rtol 1e-5.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import ARCH_IDS
from test_torch_models import make_batch
from test_torch_train import (GRAD_TOL, one_torch_thread, pair,  # noqa: F401
                              port_grads, port_named, ref_grads, ref_leaves)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_gradients_match_reference(arch):
    """``loss.backward()`` reaches every parameter, and each gradient is
    within 1e-5 of its reference leaf's largest |gradient| of
    ``jax.value_and_grad(repro.models.loss_fn)``."""
    cfg, params, model = pair(arch)
    batch = make_batch(cfg, 2, 32, seed=11)
    loss, got = port_grads(cfg, model, batch)
    want_loss, want = ref_grads(arch, params, batch)
    np.testing.assert_allclose(float(loss), float(want_loss), rtol=1e-5)
    assert all(g is not None for g in got.values())
    scale = {name: float(np.abs(a).max())
             for name, a in ref_leaves(want).items()}
    want = port_named(want)
    assert sorted(got) == sorted(want)
    for name, g in got.items():
        top, _, rest = name.partition(".")
        ref_name = (f"{top}.{rest.split('.', 1)[1]}"
                    if top in ("blocks", "shared") else name)
        err = float(np.abs(g.numpy() - want[name]).max())
        assert err <= GRAD_TOL * scale[ref_name], (name, err, scale[ref_name])
