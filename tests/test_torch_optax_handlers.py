"""Every other handler class of the port takes the optax state of a
JAX-written checkpoint of its own JAX counterpart, on the CPU: a state of the real
layout (``jax.eval_shape`` of the JAX ``init_state``, no flax compute),
filled from a numpy seed, goes through ``_load_jax_checkpoint``; every
parameter that takes a gradient must get state at the optax count, and the
loader raises on any optax leaf left over. The value-level checks (the
optimizer vocabulary, the multi-optimizer handlers) are in
``test_torch_optax_resume.py``, whose helpers this file takes.
"""

import pytest
import torch

from test_torch_optax_resume import MULTI, SMALL, _saved
from torch_parallel_worker import single_threaded  # noqa: F401 (autouse: one thread a pool)

# the handlers test_torch_optax_resume.py holds by value
BY_VALUE = {"rcan"} | {name for name, *_ in MULTI.values()}


@pytest.mark.parametrize("name", sorted(set(SMALL) - BY_VALUE))
def test_every_handler_takes_its_optax_state(name, tmp_path):
    """Every parameter that takes a gradient gets state from the JAX
    checkpoint, at the optax count, and no optax leaf is left over (the
    loader raises on either)."""
    counts = {None: 3, "generator": 4, "discriminator": 5, "generator_pre": 6,
              "sr_model": 7, "predictor": 8, "corrector": 9}.get  # one an optimizer
    _, js, th, state = _saved(name, SMALL[name], counts, tmp_path, through_file=False)
    assert state.step == 7
    targets = th.optax_targets()
    for key in ([None] if None in targets else list(js.opt_state)):
        opt = targets[key].optimizer()
        params = [p for g in opt.param_groups for p in g["params"] if p.requires_grad]
        assert params and all(p in opt.state for p in params), key
        if not isinstance(opt, torch.optim.SGD):
            assert {float(opt.state[p]["step"]) for p in params} == {counts(key)}, key
