"""Three steps of the port's ``make_train_step`` against the reference's
(jitted), from the reference's weights and batches, at one smoke config of
each family, in fp32 on the CPU, with one and two microbatches.

Tolerances: ``loss`` and ``grad_norm`` within rtol 1e-5 at each step; the
parameters after step 3 within 1e-5 of each reference leaf's largest
|value|; ``metrics["step"]`` equal.

AdamW runs with ``eps = 1e-3`` here.  Its first steps divide each gradient
by its own magnitude plus eps, so with the default 1e-8 an element whose
gradient lies within the packages' fp32 noise of zero (a few 1e-9 at these
widths, against gradients of order 1e-3) moves by a noise-dependent
fraction of lr: 1.8e-4 at lr 1e-3 was seen.  A larger eps keeps the update
a smooth function of the gradient at that scale; ``test_torch_train.py``
holds the optimizer's arithmetic at the default eps from equal inputs.
"""
import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.train as RT
from repro.configs import get_smoke_config as ref_smoke
import repro_torch.train as PT
from repro_torch.models import from_reference_params
from test_torch_train import (one_torch_thread, pair,  # noqa: F401
                              port_named, ref_leaves)

RTOL = 1e-5
FAMILIES = ["yi-6b", "olmoe-1b-7b", "mamba2-370m", "zamba2-7b",
            "pixtral-12b", "hubert-xlarge"]


@pytest.mark.parametrize("n_micro", [1, 2])
@pytest.mark.parametrize("arch", FAMILIES)
def test_train_step_matches_reference(arch, n_micro):
    cfg, params, _ = pair(arch)
    model = from_reference_params(
        cfg, jax.tree_util.tree_map(np.asarray, params), device="cpu")
    rcfg = ref_smoke(arch)
    ocfg = dict(lr=1e-3, eps=1e-3)
    rstep = jax.jit(RT.make_train_step(rcfg, RT.OptimizerConfig(**ocfg),
                                       n_micro=n_micro))
    pstep = PT.make_train_step(cfg, PT.OptimizerConfig(**ocfg),
                               n_micro=n_micro)
    data = RT.SyntheticLM(RT.DataConfig(seed=5, batch=4, seq_len=32), rcfg)
    rstate = RT.init_opt(RT.OptimizerConfig(**ocfg), params)
    pstate = PT.init_opt(PT.OptimizerConfig(**ocfg), model, device="cpu")
    rparams = params
    for step in range(3):
        batch = {k: np.asarray(v) for k, v in data.batch_at(step).items()}
        rparams, rstate, rm = rstep(rparams, rstate, batch)
        model, pstate, pm = pstep(
            model, pstate, {k: torch.from_numpy(v.copy())
                            for k, v in batch.items()})
        for key in ("loss", "grad_norm"):
            np.testing.assert_allclose(float(pm[key]), float(rm[key]),
                                       rtol=RTOL, err_msg=f"{key} {step}")
        assert int(pm["step"]) == int(rm["step"]) == step + 1
        assert all(p.grad is None for p in model.parameters())
    scale = {n: float(np.abs(a).max()) for n, a in ref_leaves(rparams).items()}
    want = port_named(rparams)
    for name, p in model.named_parameters():
        top, _, rest = name.partition(".")
        ref_name = (f"{top}.{rest.split('.', 1)[1]}"
                    if top in ("blocks", "shared") else name)
        err = float(np.abs(p.detach().numpy() - want[name]).max())
        assert err <= RTOL * scale[ref_name], (name, err)


def test_sharding_arguments_raise():
    """``grad_shardings`` places DTensor gradients: a model of plain
    tensors, or a placement map that misses a parameter, raises
    ``TypeError`` at the step (``test_torch_sharding.py`` runs the
    options on meshes)."""
    cfg, params, _ = pair("yi-6b")
    model = from_reference_params(
        cfg, jax.tree_util.tree_map(np.asarray, params), device="cpu")
    opt = PT.init_opt(PT.OptimizerConfig(), model, device="cpu")
    batch = {"tokens": torch.zeros((2, 8), dtype=torch.int32),
             "labels": torch.zeros((2, 8), dtype=torch.int32)}
    for kw in (dict(grad_shardings={}),
               dict(grad_shardings={n: () for n, _ in
                                    model.named_parameters()},
                    gather_weights_once=True)):
        step = PT.make_train_step(cfg, PT.OptimizerConfig(), **kw)
        with pytest.raises(TypeError, match="DTensor parameter"):
            step(model, opt, batch)
