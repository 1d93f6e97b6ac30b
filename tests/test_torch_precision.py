"""The port's ``utils/precision.py``: float64 runs of its float32 code.

``float_as_double`` widens ``Tensor.float()`` inside its block only, on the
calling thread only; ``float64`` widens a handler (module, ``dtype``
fields, draws) and gives torch's default dtype back on exit.
"""

import threading

import torch

from rumpy_tpu_torch.registry import get_model
from rumpy_tpu_torch.utils.precision import float64, float_as_double
from torch_parallel_worker import single_threaded  # noqa: F401 (autouse: one thread a pool)


def test_float_as_double_is_scoped_to_its_block_and_thread():
    x = torch.ones(2, dtype=torch.float64)
    seen = {}

    def other():
        seen["thread"] = x.float().dtype

    with float_as_double():
        inside = (x.float().dtype, torch.Tensor.float(x).dtype)
        t = threading.Thread(target=other)
        t.start()
        t.join()
    assert inside == (torch.float64, torch.float64)
    assert seen["thread"] == torch.float32 and x.float().dtype == torch.float32


def test_float64_widens_a_handler_for_its_block():
    h = get_model("facegan")(device="cpu", latent_dim=4, nf=4)
    h.init_state()
    with float64(h) as state:
        assert torch.get_default_dtype() == torch.float64 and torch.rand(1).dtype == torch.float64
        assert all(v.dtype == torch.float64 for v in state.params.values()
                   if v.is_floating_point())
        assert all(m.dtype == torch.float64 for m in h.module.modules() if hasattr(m, "dtype"))
        assert h.discriminator.norms[0].running_mean.float().dtype == torch.float64
    assert torch.get_default_dtype() == torch.float32
    assert torch.ones(1).float().dtype == torch.float32
