"""``make_accum_train_step`` against the JAX package's on the CPU: two
microbatches of 2 (B=4, dropout off) for the proj family
(``I2PNetProjConfig.tiny()``) and the free-point family
(``I2PNetConfig.tiny()``), both in f32 with JAX op by op. Compared: the
metrics (the microbatches' mean), Adam's first moments after the update
(0.1 x the averaged gradient plus the decay term; the parameters
themselves would turn gradient noise into +-lr) and the running
statistics, which move microbatch by microbatch. One file apart from
``test_torch_trainer.py`` so that the two build their JAX references in
parallel.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from i2pnet_tpu.models import I2PNet as JaxI2PNet
from i2pnet_tpu.models import I2PNetProj as JaxI2PNetProj
from i2pnet_tpu.train import create_train_state as jax_train_state
from i2pnet_tpu.train import make_accum_train_step as jax_accum_step
from i2pnet_tpu_torch.convert import flax_to_state_dict
from i2pnet_tpu_torch.train import create_train_state, make_accum_train_step
from _torch_util import n
from test_torch_trainer import (
    ABSORBED,
    METRICS,
    _free_batch,
    _free_cfg,
    _jcfg,
    _port_model,
    _proj_batch,
    _proj_cfg,
    _tbatch,
    _variables,
)


def _adam_mu(opt_state):
    mu = next(s.mu for s in jax.tree_util.tree_leaves(
        opt_state, is_leaf=lambda s: hasattr(s, "mu")) if hasattr(s, "mu"))
    return flax_to_state_dict({"params": jax.tree_util.tree_map(np.asarray, mu)})


@pytest.mark.parametrize("proj", [True, False], ids=["proj", "free"])
def test_accum_step_matches_jax(proj):
    """Two microbatches of 2: the metrics within 1e-4, Adam's first moment
    of every leaf within 1e-3 of the leaf's max (the plain steps' f32 bar on
    the gradients), the running statistics within 1e-4. JAX runs op by op
    for both families: on this batch its jitted proj step is 2.3e-3 of a
    leaf's max from its own op-by-op step (a cost-volume norm's scale,
    where XLA reassociates a sensitive sum), and the port follows the
    op-by-op step within 1.5e-4; its jitted free step differs by up to 1%
    (tests/test_torch_train.py)."""
    cfg = _proj_cfg() if proj else _free_cfg()
    batch = _proj_batch() if proj else _free_batch()
    jm = (JaxI2PNetProj if proj else JaxI2PNet)(_jcfg(cfg))
    jstate = jax_train_state(jm, _variables(proj), steps_per_epoch=100)
    step = jax_accum_step(jm, _jcfg(cfg), 2, proj=proj)
    with jax.disable_jit():
        jstate, jmetrics = step(jstate, {k: jnp.asarray(v) for k, v in batch.items()},
                                jax.random.key(0))

    model = _port_model(proj, cfg)
    state = create_train_state(model, steps_per_epoch=100)
    metrics = make_accum_train_step(model, cfg, 2, proj=proj)(state, _tbatch(batch))
    assert state.step == 1
    for key in METRICS:
        np.testing.assert_allclose(n(metrics[key]), n(jmetrics[key]), rtol=1e-4, atol=1e-4,
                                   err_msg=key)
    ref = _adam_mu(jstate.opt_state)
    params = dict(model.named_parameters())
    assert set(ref) == set(params)
    for name, mu in ref.items():
        if ABSORBED.search(name):
            continue
        got = n(state.optimizer.state[params[name]]["exp_avg"])
        scale = float(np.abs(mu.numpy()).max()) + 1e-12
        np.testing.assert_allclose(got / scale, mu.numpy() / scale, atol=1e-3, err_msg=name)
    ref = flax_to_state_dict({"batch_stats": jax.tree_util.tree_map(np.asarray,
                                                                    jstate.batch_stats)})
    buffers = dict(model.named_buffers())
    assert set(ref) == set(buffers) and ref
    for name, r in ref.items():
        np.testing.assert_allclose(n(buffers[name]), r.numpy(), rtol=1e-4, atol=1e-4,
                                   err_msg=name)
